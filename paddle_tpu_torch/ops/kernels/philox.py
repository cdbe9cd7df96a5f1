"""The keep mask of flash attention's in-kernel dropout: one definition
for the CUDA kernels (``csrc/philox.cuh``) and their plain versions.

Replaces ``paddle_tpu/ops/pallas/flash_attention.py::_drop_mask``
(:50-72), which draws the mask from the TPU core's PRNG keyed on (seed,
offset, head, q block, k block). A TPU's bits cannot be reproduced
here, so the port keeps the semantics and not the bits: a
counter-based Philox4x32-10 (Salmon et al., "Parallel random numbers:
as easy as 1, 2, 3", SC 2011; the generator of Random123 and of
cuRAND's Philox) that the kernels and this module compute identically.

- The key is the call's two uint32 words ``(seed, offset)``.
- Element ``(bh, row, col)`` of the ``[b * h, sq, sk]`` score matrix
  (``bh = batch * heads + head``, ``row`` the query, ``col`` the key)
  takes word ``col & 3`` of the Philox block at counter
  ``(col >> 2, row, bh, 0)``.
- It is kept when that word is at least ``drop_threshold(p) = min(int(p
  * 2**32), 2**32 - 1)``, the threshold of ``_drop_mask`` (:68-71).

The mask is a function of the element alone, so no tile size of any
kernel changes it, and the forward and both backward kernels draw the
same mask without storing it.

The plain arithmetic runs on int64 tensors masked to 32 bits (torch has
no uint32 arithmetic on every device): a 32 x 32-bit product is taken
in 16-bit halves so that no intermediate leaves int64.
"""

from __future__ import annotations

import torch

__all__ = ["philox4x32", "drop_threshold", "keep_mask"]

_M32 = 0xFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)   # round multipliers
PHILOX_W = (0x9E3779B9, 0xBB67AE85)   # Weyl key increments
_ROUNDS = 10


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit words of ``a * b`` for a constant ``a`` and int64
    ``b`` in [0, 2**32)."""
    p_lo = a * (b & 0xFFFF)                 # < 2**48
    p_hi = a * (b >> 16)                    # < 2**48
    t = p_lo + ((p_hi & 0xFFFF) << 16)      # < 2**49
    return (t >> 32) + (p_hi >> 16), t & _M32


def philox4x32(ctr, key):
    """Philox4x32-10 of the counter ``ctr`` (four int64 tensors or ints in
    [0, 2**32), broadcast together) under ``key`` (two such words):
    the four output words as int64 tensors in [0, 2**32)."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in ctr)
    k0, k1 = (torch.as_tensor(k, dtype=torch.int64) for k in key)
    for r in range(_ROUNDS):
        if r:
            k0 = (k0 + PHILOX_W[0]) & _M32
            k1 = (k1 + PHILOX_W[1]) & _M32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def drop_threshold(p: float) -> int:
    """The uint32 threshold of a drop probability (``_drop_mask``
    :68-71): a word below it drops its element."""
    return min(int(p * 4294967296.0), 4294967295)


def keep_mask(seed_arr: torch.Tensor, p: float, n_bh: int, sq: int,
              sk: int, *, bh0: int = 0, row0: int = 0,
              col0: int = 0) -> torch.Tensor:
    """bool ``[n_bh, sq, sk]``: the keep mask of elements ``(bh0 + i, row0
    + j, col0 + c)`` under ``seed_arr`` (int64 ``[2]``: seed, offset, on
    the device the mask is made on). A block of the mask equals the same
    slice of a larger one."""
    dev = seed_arr.device
    seed = seed_arr.to(torch.int64) & _M32
    c_lo, c_hi = col0 >> 2, (col0 + sk + 3) >> 2    # the counters' groups
    grp = torch.arange(c_lo, c_hi, device=dev)[None, None, :]
    row = torch.arange(row0, row0 + sq, device=dev)[None, :, None]
    bh = torch.arange(bh0, bh0 + n_bh, device=dev)[:, None, None]
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    words = philox4x32((grp, row, bh, zero), (seed[0], seed[1]))
    thresh = drop_threshold(p)
    keep = torch.stack([w >= thresh for w in words], dim=-1)  # [.., g, 4]
    keep = keep.expand(n_bh, sq, c_hi - c_lo, 4).reshape(n_bh, sq, -1)
    start = col0 - 4 * c_lo
    return keep[:, :, start:start + sk]
