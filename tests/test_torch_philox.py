"""The dropout keep mask of the port's flash kernels
(``paddle_tpu_torch/ops/kernels/philox.py``; the CUDA kernels compute the
same words in ``csrc/philox.cuh``).

- Philox4x32-10 against the Random123 known answers (counter 0 / key 0,
  all ones, the digits of pi): exact;
- the mask is a function of the element alone: any block of it equals
  the same slice of a larger mask (so no tile size of a kernel changes
  it);
- the keep rate lies within 4 standard deviations of ``1 - p``;
- the threshold is the JAX ``_drop_mask``'s (``min(int(p * 2**32),
  2**32 - 1)``), and each element takes word ``col & 3`` of the block at
  counter ``(col >> 2, row, bh, 0)``.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels.philox import (drop_threshold, keep_mask,
                                                 philox4x32)
from torch_one_thread import one_torch_thread  # noqa: F401

M = 0xFFFFFFFF
KAT = [  # (counter, key, output) of Random123's kat_vectors, philox4x32 10
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((M, M, M, M), (M, M),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,want", KAT)
def test_philox_known_answers(ctr, key, want):
    got = tuple(int(w) for w in philox4x32(ctr, key))
    assert got == want, [hex(w) for w in got]


def test_philox_is_elementwise_over_tensors():
    """Counters broadcast: each element equals its own scalar call."""
    rng = np.random.default_rng(0)
    c = rng.integers(0, 1 << 32, (4, 7), dtype=np.int64)
    key = (int(rng.integers(0, 1 << 32)), int(rng.integers(0, 1 << 32)))
    words = philox4x32(tuple(torch.tensor(x) for x in c), key)
    for j in (0, 3, 6):
        one = philox4x32(tuple(int(x) for x in c[:, j]), key)
        assert [int(w[j]) for w in words] == [int(w) for w in one]


def test_mask_block_equals_slice_of_the_whole():
    seed = torch.tensor([123456789, 987654321])
    whole = keep_mask(seed, 0.1, 6, 70, 133)
    for bh0, row0, col0, n, sq, sk in [(0, 0, 0, 6, 70, 133),
                                       (3, 5, 7, 2, 10, 13),
                                       (1, 64, 64, 4, 6, 69),
                                       (5, 69, 130, 1, 1, 3)]:
        sub = keep_mask(seed, 0.1, n, sq, sk, bh0=bh0, row0=row0, col0=col0)
        assert torch.equal(sub, whole[bh0:bh0 + n, row0:row0 + sq,
                                      col0:col0 + sk])


def test_mask_takes_word_col_mod_4_of_its_block():
    seed = torch.tensor([42, 7])
    p = 0.3
    mask = keep_mask(seed, p, 3, 5, 11)
    for bh, row, col in [(0, 0, 0), (2, 4, 10), (1, 3, 5), (0, 1, 7)]:
        words = philox4x32((col >> 2, row, bh, 0), (42, 7))
        assert bool(mask[bh, row, col]) == (int(words[col & 3])
                                           >= drop_threshold(p))


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
def test_keep_rate_within_4_sigma(p):
    n_bh, sq, sk = 8, 128, 256
    mask = keep_mask(torch.tensor([2024, 1]), p, n_bh, sq, sk)
    n = mask.numel()
    rate = mask.float().mean().item()
    assert abs(rate - (1 - p)) <= 4 * np.sqrt(p * (1 - p) / n), rate


def test_threshold_and_keys():
    assert drop_threshold(0.0) == 0
    assert drop_threshold(0.5) == 1 << 31
    assert drop_threshold(1.0) == M
    a = keep_mask(torch.tensor([1, 2]), 0.5, 2, 16, 16)
    b = keep_mask(torch.tensor([1, 3]), 0.5, 2, 16, 16)
    assert not torch.equal(a, b)
    assert torch.equal(a, keep_mask(torch.tensor([1, 2]), 0.5, 2, 16, 16))
    assert keep_mask(torch.tensor([1, 2]), 0.0, 2, 16, 16).all()
