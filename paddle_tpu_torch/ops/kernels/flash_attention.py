"""Kernels 3-5: flash attention forward, dQ and dK/dV (CUDA,
``csrc/flash_attention_fwd.cu`` and ``csrc/flash_attention_bwd.cu``,
whose bf16 modes without segment ids, with or without a bias and
dropout, run the wgmma kernels of ``csrc/flash_fwd_wgmma.cuh`` (the
forward) and ``csrc/flash_bwd_wgmma.cuh`` (dQ and dK/dV), and whose
fp32 modes at head_dim 64 without segment ids, with or without a bias
and dropout, the TF32 wgmma kernels of ``csrc/flash_fwd_tf32.cuh`` (the
forward) and ``csrc/flash_bwd_tf32.cuh`` (dQ and dK/dV); every other
mode, fp32 at head_dim 128 and the segment mode, runs the ``mma.sync``
kernels of the two ``.cu`` files).

Replaces ``paddle_tpu/ops/pallas/flash_attention.py``: ``_fwd`` (its
``pallas_call`` at :242) and the two ``pallas_call``s of
``flash_block_grads`` (dQ :558, dK/dV :590), causal and non-causal, with
and without the additive bias (``has_bias``), with and without in-kernel
dropout (``dropout_p``: ``_flash_drop`` :660, ``_flash_bias_drop`` :684),
with per-token segment ids (``has_seg``: ``flash_attn_unpadded`` :765),
on bf16 or fp32 inputs. See the sources for what bounds them on the
H100 and how the designs answer that. Layout ``[batch, seq, heads,
head_dim]`` as in the JAX package; ``lse`` and ``delta`` are fp32
``[batch, heads, seq_q]``; a bias is fp32 ``[b|1, h|1, sq, sk]``, added
to the scaled scores before the softmax; a dropout key ``seed_arr`` is
an int64 ``[2]`` (seed, offset) on q's device (``philox.py`` defines the
keep mask it keys); segment ids are int32 ``[sq]`` and ``[sk]``, shared
by every batch row and head, and a query sees only keys of its own id
(:class:`SegIds`, made by :func:`seg_ids`).

- :func:`flash_fwd_plain`, :func:`flash_block_grads_plain` — the plain
  PyTorch versions (CPU path, tests, and what the kernels are held
  against on the card). They keep the Pallas arithmetic: fp32 q, k, v
  (fp64 for fp64 inputs: the reference the fp32 kernels are measured
  against); the forward scales q before the QK product, the backward
  scales the product after; masked scores take the finite ``-1e30`` and
  the subtracted max is clamped at ``-1e25``, so a fully masked row
  gives ``out = 0`` and ``lse = -1e30``; causal masks align bottom-right
  (row r sees columns ``<= r + sk - sq``); the segment mask follows the
  causal one (:143-146); a bias is added after both; dropout as the
  Pallas kernels apply it (:149-163, :376-385, :440-458): the normaliser
  sums the undropped P, the PV product and dV take ``keep ? P / (1 - p)
  : 0``, and dP is masked and scaled before ``dS = P * (dP - delta) *
  scale``.
- :func:`flash_fwd_cuda`, :func:`flash_bwd_dq_cuda`,
  :func:`flash_bwd_dkv_cuda` — the kernels' wrappers: they launch on
  CUDA tensors or raise outside :func:`kernel_gate`, :func:`bias_gate`,
  :func:`seed_gate` and :func:`seg_gate`. q, k, v (and dO) share one
  dtype, bf16 or fp32: bf16 runs on bf16 tensor cores, fp32 keeps fp32
  accuracy (3xTF32), and no input is rounded to another type. Each
  wrapper counts its launches per mode in the attribute
  :func:`mode_attr` names (``launches``, ``bias_launches``,
  ``fp32_launches``, ..., ``fp32_drop_bias_launches``, ``seg_launches``,
  ``fp32_seg_launches``). The bias goes to the kernels through its
  strides, so a broadcast dimension (stride 0) is never materialised.
  The segment mode takes no bias and no dropout: no path of the JAX
  package combines them, and the wrappers raise on it.
- :func:`flash_attention` (differentiable in q, k and v; the mask and the
  dropout key are not), :func:`flash_attention_with_lse`,
  :func:`flash_block_grads` and :func:`flash_attn_unpadded` (packed
  ``[total, h, d]`` sequences with their ``cu_seqlens``) — the public
  functions, with the JAX package's signatures. A CPU tensor, or a CUDA
  tensor inside ``plain_reference()``, takes the plain versions.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from .build import library
from .philox import drop_threshold, keep_mask
from .routing import use_kernel

__all__ = ["flash_attention", "flash_attention_with_lse",
           "flash_block_grads", "flash_fwd_plain", "flash_block_grads_plain",
           "flash_fwd_cuda", "flash_bwd_dq_cuda", "flash_bwd_dkv_cuda",
           "flash_delta", "kernel_gate", "bias_gate", "seed_gate",
           "seed_pair", "pad_bias", "attn_bias", "mode_attr", "MODES",
           "HEAD_DIMS", "SegIds", "seg_ids", "seg_gate", "SEG_GRAIN",
           "flash_attn_unpadded"]

HEAD_DIMS = (64, 128)
NEG = -1e30          # the Pallas kernels' finite mask value
_CLAMP = -1e25       # clamp of the subtracted max / lse (fully masked rows)
_SEG_ALONE = ("segment ids with a bias or with dropout: no path of the "
              "JAX package combines them, so the kernels have no such mode "
              "(ROADMAP.md B5)")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# (fp32, dropout, bias, segment ids) of each kernel mode, in the counters'
# order: every combination of the first three, and segment ids alone
MODES = tuple((f, d, b, False) for f in (False, True) for d in (False, True)
              for b in (False, True)) + tuple(
    (f, False, False, True) for f in (False, True))
# tokens a [min, max] id range covers (csrc/flash_common.cuh kSegGrain);
# every tile of the kernels is a whole number of grains
SEG_GRAIN = 32


def mode_attr(fp32: bool, drop: bool, bias: bool, seg: bool = False) -> str:
    """The wrapper attribute that counts a mode's launches."""
    return ("fp32_" * fp32 + "drop_" * drop + "bias_" * bias
            + "seg_" * seg) + "launches"


def _compute_dtype(t: torch.Tensor) -> torch.dtype:
    """fp32, or fp64 for fp64 inputs (the plain versions' reference use)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _inv_keep(p: float, dtype: torch.dtype) -> float:
    """1 / (1 - p) as the kernels multiply by it (rounded to fp32 first,
    for fp32 compute; in full for fp64)."""
    inv = 1.0 / (1.0 - p)
    return inv if dtype == torch.float64 else float(
        torch.tensor(inv, dtype=torch.float32))


def _dropped(x, dropout_p: float, seed_arr):
    """``keep ? x / (1 - p) : 0`` over ``[b, h, sq, sk]`` scores, the keep
    mask of ``philox.keep_mask`` under ``seed_arr``."""
    b, h, sq, sk = x.shape
    keep = keep_mask(seed_arr.to(x.device), dropout_p, b * h, sq, sk)
    return torch.where(keep.view(b, h, sq, sk),
                       x * _inv_keep(dropout_p, x.dtype),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_keep(sq: int, sk: int, device) -> torch.Tensor:
    """[sq, sk] bool: row r keeps columns <= r + (sk - sq)."""
    rows = torch.arange(sq, device=device)[:, None]
    cols = torch.arange(sk, device=device)[None, :]
    return rows + (sk - sq) >= cols


class SegIds(NamedTuple):
    """Segment ids of a packed batch, on one device (:func:`seg_ids`):
    ``q`` int32 ``[sq]`` and ``k`` int32 ``[sk]``; ``q_info`` int32
    ``[ceil(sq / SEG_GRAIN), 4]``: for each grain of ``SEG_GRAIN`` queries
    the min and max of its ids and the range ``[first, end)`` of key
    grains outside which no key can share an id with it; ``k_info`` the
    same for key grains over query grains. The kernels skip every tile
    pair whose id ranges do not meet and loop only over ``[first, end)``:
    right for any ids, and tight for the sorted ids of ``cu_seqlens``."""
    q: torch.Tensor
    k: torch.Tensor
    q_info: torch.Tensor
    k_info: torch.Tensor


def _ids(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32).reshape(-1) \
            .contiguous()
    return torch.as_tensor(np.asarray(x).reshape(-1), dtype=torch.int32,
                           device=device)


def _grain_range(ids):
    """Per grain of ``SEG_GRAIN`` ids: (min, max), int64; the last grain
    is padded with its own last id."""
    n = ids.numel()
    g = -(-n // SEG_GRAIN)
    if g * SEG_GRAIN > n:
        ids = torch.cat([ids, ids[-1:].expand(g * SEG_GRAIN - n)])
    v = ids.view(g, SEG_GRAIN).long()
    return v.amin(1), v.amax(1)


def _grain_info(lo, hi, other_lo, other_hi) -> torch.Tensor:
    """``[g, 4]`` int32 rows (lo, hi, first, end): other grains j < first
    have a running max of ``other_hi`` below lo, grains j >= end a
    suffix min of ``other_lo`` above hi, so neither can meet [lo, hi]."""
    if other_lo.numel() == 0:
        first = end = torch.zeros_like(lo)
    else:
        run_max = torch.cummax(other_hi, 0).values
        suf_min = torch.cummin(other_lo.flip(0), 0).values.flip(0)
        first = torch.searchsorted(run_max, lo)
        end = torch.searchsorted(suf_min, hi, right=True)
    return torch.stack([lo, hi, first, end], 1).to(torch.int32).contiguous()


def seg_ids(seg_q, seg_k, device=None) -> SegIds:
    """:class:`SegIds` of per-token ids ``seg_q`` ``[sq]`` and ``seg_k``
    ``[sk]`` (arrays, lists or tensors), computed on ``device`` (default:
    the tensors' own, else the CPU) by a few torch ops."""
    if device is None:
        device = (seg_q.device if isinstance(seg_q, torch.Tensor)
                  else torch.device("cpu"))
    q, k = _ids(seg_q, device), _ids(seg_k, device)
    q_lo, q_hi = _grain_range(q)
    k_lo, k_hi = _grain_range(k)
    return SegIds(q, k, _grain_info(q_lo, q_hi, k_lo, k_hi),
                  _grain_info(k_lo, k_hi, q_lo, q_hi))


def _as_seg(seg, device) -> SegIds | None:
    """``seg`` as :class:`SegIds` on ``device``: a ``(seg_q, seg_k)``
    pair (the JAX package's form) is converted."""
    if seg is None or isinstance(seg, SegIds):
        return seg
    return seg_ids(seg[0], seg[1], device)


def _seg_keep(seg, device) -> torch.Tensor:
    """[sq, sk] bool: query r keeps key c when their ids are equal."""
    seg_q, seg_k = (seg.q, seg.k) if isinstance(seg, SegIds) else seg
    return _ids(seg_q, device)[:, None] == _ids(seg_k, device)[None, :]


def flash_fwd_plain(q, k, v, scale: float, causal: bool, bias=None,
                    dropout_p: float = 0.0, seed_arr=None, seg=None):
    """``(out, lse)`` of ``_fwd`` / ``_fwd_kernel`` (flash_attention.py:96-265)
    computed in one block: out in q's dtype, lse ``[b, h, sq]`` in the
    compute dtype (fp32; fp64 for fp64 inputs); with ``seg`` (a
    :class:`SegIds` or a ``(seg_q, seg_k)`` pair) a query keeps the keys
    of its own id after the causal mask (:143-146); ``bias`` (fp32,
    broadcastable to ``[b, h, sq, sk]``) is added after ``(q * scale) k``
    and the masks (:146-148); with ``dropout_p`` the PV product takes the
    dropped, rescaled P under ``seed_arr`` and the normaliser the
    undropped one (:149-163)."""
    sq, sk = q.shape[1], k.shape[1]
    ct = _compute_dtype(q)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(ct) * scale, k.to(ct))
    if causal:
        s = torch.where(_causal_keep(sq, sk, q.device), s,
                        torch.tensor(NEG, dtype=ct, device=q.device))
    if seg is not None:
        s = torch.where(_seg_keep(seg, q.device), s,
                        torch.tensor(NEG, dtype=ct, device=q.device))
    if bias is not None:
        s = s + bias.to(ct)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m.clamp(min=_CLAMP))
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    if dropout_p:
        p = _dropped(p, dropout_p, seed_arr)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.to(ct))
    out = out / l_safe.permute(0, 2, 1, 3)
    lse = (m + torch.log(l_safe))[..., 0]
    return out.to(q.dtype), lse


def flash_delta(do, out) -> torch.Tensor:
    """delta = rowsum(dO * O) ``[b, h, sq]`` (``_delta`` :466), in fp32
    (fp64 for fp64 inputs)."""
    ct = _compute_dtype(do)
    return (do.to(ct) * out.to(ct)).sum(dim=-1).transpose(1, 2) \
        .contiguous()


def flash_block_grads_plain(q, k, v, do, lse, delta, scale: float,
                            causal: bool, bias=None, dropout_p: float = 0.0,
                            seed_arr=None, seg=None):
    """``(dq, dk, dv)`` of ``flash_block_grads`` (:478-612) in one block:
    P recomputed from ``lse`` (the causal and segment masks, then
    ``bias`` added after ``(q k) * scale``, :363-374 and :433-437),
    ``dS = P * (dP - delta) * scale``; with ``dropout_p`` dP is masked
    and rescaled first and dV takes the dropped P (:376-385, :440-458);
    dq in q's dtype, dk and dv in k's and v's."""
    sq, sk = q.shape[1], k.shape[1]
    ct = _compute_dtype(q)
    qf, kf, vf, dof = (x.to(ct) for x in (q, k, v, do))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if causal:
        s = torch.where(_causal_keep(sq, sk, q.device), s,
                        torch.tensor(NEG, dtype=ct, device=q.device))
    if seg is not None:
        s = torch.where(_seg_keep(seg, q.device), s,
                        torch.tensor(NEG, dtype=ct, device=q.device))
    if bias is not None:
        s = s + bias.to(ct)
    p = torch.exp(s - lse.to(ct).clamp(min=_CLAMP)[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    p_drop = p
    if dropout_p:
        p_drop = _dropped(p, dropout_p, seed_arr)
        dp = _dropped(dp, dropout_p, seed_arr)
    ds = p * (dp - delta.to(ct)[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p_drop, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------- the kernels' wrappers ----------------

def _rows_ok(t: torch.Tensor) -> bool:
    """16-byte vector loads (8 bf16 or 4 fp32 elements): unit stride on
    d, the other strides multiples of the vector, 16-byte aligned
    storage."""
    per = 16 // t.element_size()
    return (t.stride(3) == 1 and all(s % per == 0 for s in t.stride()[:3])
            and t.data_ptr() % 16 == 0)


def kernel_gate(q, k, v, do=None, lse=None, delta=None) -> str | None:
    """None when the kernels take these inputs, else the reason."""
    tensors = [t for t in (q, k, v, do, lse, delta) if t is not None]
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        return "all inputs must be on one CUDA device"
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        return "q, k, v must be [b, s, h, d] with k and v of one shape"
    b, sq, h, d = q.shape
    if k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        return (f"k/v {tuple(k.shape)} must share batch, heads and head "
                f"dim with q {tuple(q.shape)} (repeat GQA heads first)")
    if d not in HEAD_DIMS:
        return f"head dim must be one of {HEAD_DIMS}; got {d}"
    if q.dtype not in _DTYPE_CODE or not q.dtype == k.dtype == v.dtype:
        return (f"q, k, v must share one dtype, bfloat16 or float32 (bf16 "
                f"tensor cores, or fp32-accurate 3xTF32); got {q.dtype}, "
                f"{k.dtype}, {v.dtype}")
    if do is not None:
        if do.shape != q.shape or do.dtype != q.dtype:
            return "dO must have q's shape and dtype"
        for name, t in (("lse", lse), ("delta", delta)):
            if (t is None or t.dtype != torch.float32
                    or tuple(t.shape) != (b, h, sq) or not t.is_contiguous()):
                return f"{name} must be contiguous float32 [b, h, sq]"
    if not all(_rows_ok(t) for t in (q, k, v) + ((do,) if do is not None
                                                 else ())):
        per = 16 // q.element_size()
        return (f"q, k, v (and dO) need unit stride on head_dim, strides "
                f"that are multiples of {per} and 16-byte aligned storage")
    if b * h > 65535:
        return "at most 65535 batch*heads"
    return None


def bias_gate(bias, q, k) -> str | None:
    """None when the kernels take ``bias`` with these q and k, else the
    reason: fp32 on q's device, ``[b|1, h|1, sq, sk]``, any strides."""
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    if not (bias.is_cuda and bias.device == q.device):
        return "the bias must be on q's CUDA device"
    if bias.dtype != torch.float32:
        return f"the bias must be float32; got {bias.dtype}"
    if (bias.dim() != 4 or bias.shape[0] not in (1, b)
            or bias.shape[1] not in (1, h)
            or tuple(bias.shape[2:]) != (sq, sk)):
        return (f"the bias {tuple(bias.shape)} must be [b|1, h|1, sq, sk] "
                f"for [{b}, {h}, {sq}, {sk}]")
    return None


def seed_gate(dropout_p, seed_arr, q) -> str | None:
    """None when the kernels take this dropout, else the reason:
    ``0 <= dropout_p < 1``, and for ``dropout_p > 0`` a contiguous int64
    ``[2]`` key on q's device."""
    if not 0.0 <= dropout_p < 1.0:
        return f"dropout_p must lie in [0, 1); got {dropout_p}"
    if not dropout_p:
        return None
    if seed_arr is None:
        return "dropout needs its (seed, offset) key, seed_arr"
    if not (seed_arr.is_cuda and seed_arr.device == q.device):
        return "seed_arr must be on q's CUDA device"
    if (seed_arr.dtype != torch.int64 or tuple(seed_arr.shape) != (2,)
            or not seed_arr.is_contiguous()):
        return "seed_arr must be a contiguous int64 [2] (seed, offset)"
    return None


def seg_gate(seg, q, k) -> str | None:
    """None when the kernels take these segment ids with q and k, else
    the reason: a :class:`SegIds` of contiguous int32 tensors on q's
    device, ids ``[sq]`` and ``[sk]``, grain summaries of
    ``ceil(s / SEG_GRAIN)`` rows."""
    if not isinstance(seg, SegIds):
        return "segment ids must be a SegIds (seg_ids(seg_q, seg_k))"
    sq, sk = q.shape[1], k.shape[1]
    want = {"q": (sq,), "k": (sk,), "q_info": (-(-sq // SEG_GRAIN), 4),
            "k_info": (-(-sk // SEG_GRAIN), 4)}
    for name, shape in want.items():
        t = getattr(seg, name)
        if not (t.is_cuda and t.device == q.device):
            return f"segment ids ({name}) must be on q's CUDA device"
        if (t.dtype != torch.int32 or tuple(t.shape) != shape
                or not t.is_contiguous()):
            return (f"segment ids ({name}) must be contiguous int32 "
                    f"{list(shape)}; got {t.dtype} {list(t.shape)}")
    return None


def _check(name, *args, bias=None, dropout_p=0.0, seed_arr=None, seg=None):
    why = kernel_gate(*args)
    if why is None and bias is not None:
        why = bias_gate(bias, args[0], args[1])
    if why is None:
        why = seed_gate(dropout_p, seed_arr, args[0])
    if why is None and seg is not None:
        why = (_SEG_ALONE if bias is not None or dropout_p
               else seg_gate(seg, args[0], args[1]))
    if why is not None:
        raise ValueError(f"{name}: {why}")


def _fn(lib: str, sym: str, n_ptr: int, n_int: int):
    fn = getattr(library(lib), sym)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int64] * n_int
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_uint32, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _strides(*ts):
    return [s for t in ts for s in t.stride()[:3]]


def _bias_args(bias):
    """The bias pointer (None: no bias) and its four element strides, 0 on
    a dimension of size 1 (broadcast)."""
    if bias is None:
        return None, [0, 0, 0, 0]
    return bias.data_ptr(), [0 if n == 1 else st
                             for n, st in zip(bias.shape, bias.stride())]


def _mode_args(q, dropout_p, seed_arr):
    """The C interface's tail: (dtype code, Philox threshold, 1 / (1 -
    p)) and the key pointer (None: no dropout)."""
    if not dropout_p:
        return None, (_DTYPE_CODE[q.dtype], 0, 1.0)
    return seed_arr.data_ptr(), (_DTYPE_CODE[q.dtype],
                                 drop_threshold(dropout_p),
                                 _inv_keep(dropout_p, torch.float32))


def _seg_args(seg):
    """The four segment pointers (ids of q and k, their grain
    summaries); all None without segment ids."""
    if seg is None:
        return [None] * 4
    return [t.data_ptr() for t in seg]


def _count(fn, q, bias, dropout_p, seg):
    attr = mode_attr(q.dtype == torch.float32, bool(dropout_p),
                     bias is not None, seg is not None)
    setattr(fn, attr, getattr(fn, attr) + 1)


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def flash_fwd_cuda(q, k, v, scale: float, causal: bool, bias=None,
                   dropout_p: float = 0.0, seed_arr=None, seg=None):
    """Launch the forward kernel: ``(out [b, sq, h, d] in q's dtype,
    lse fp32 [b, h, sq])``; with ``bias`` its bias mode, with
    ``dropout_p > 0`` its dropout mode under the key ``seed_arr``, with
    ``seg`` (:class:`SegIds`, or a ``(seg_q, seg_k)`` pair) its segment
    mode. Raises ValueError outside :func:`kernel_gate`,
    :func:`bias_gate`, :func:`seed_gate` and :func:`seg_gate`."""
    seg = _as_seg(seg, q.device)
    _check("flash_fwd_cuda", q, k, v, bias=bias, dropout_p=dropout_p,
           seed_arr=seed_arr, seg=seg)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse.fill_(NEG)
    bptr, bst = _bias_args(bias)
    sptr, tail = _mode_args(q, dropout_p, seed_arr)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _fn("flash_attention_fwd", "flash_fwd_launch", 11, 18)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), bptr, sptr, *_seg_args(seg), b, h, sq, sk, d,
            *_strides(q, k, v), *bst, float(scale), int(bool(causal)),
            *tail, stream)
    _raise_on(err, "flash attention forward")
    _count(flash_fwd_cuda, q, bias, dropout_p, seg)
    return out, lse


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale: float, causal: bool,
                      bias=None, dropout_p: float = 0.0, seed_arr=None,
                      seg=None):
    """Launch the dQ kernel (with ``bias``: its bias mode; with
    ``dropout_p > 0``: its dropout mode under the forward's
    ``seed_arr``; with ``seg``: its segment mode); dq in q's dtype,
    contiguous."""
    seg = _as_seg(seg, q.device)
    _check("flash_bwd_dq_cuda", q, k, v, do, lse, delta, bias=bias,
           dropout_p=dropout_p, seed_arr=seed_arr, seg=seg)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    if dq.numel() == 0:
        return dq
    if sk == 0:
        return dq.zero_()
    bptr, bst = _bias_args(bias)
    sptr, tail = _mode_args(q, dropout_p, seed_arr)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _fn("flash_attention_bwd", "flash_bwd_dq_launch", 13, 21)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bptr, sptr,
            *_seg_args(seg), b, h, sq, sk, d, *_strides(q, k, v, do), *bst,
            float(scale), int(bool(causal)), *tail, stream)
    _raise_on(err, "flash attention dQ")
    _count(flash_bwd_dq_cuda, q, bias, dropout_p, seg)
    return dq


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, scale: float,
                       causal: bool, bias=None, dropout_p: float = 0.0,
                       seed_arr=None, seg=None):
    """Launch the dK/dV kernel (with ``bias``: its bias mode; with
    ``dropout_p > 0``: its dropout mode under the forward's
    ``seed_arr``; with ``seg``: its segment mode); dk, dv in k's dtype,
    contiguous."""
    seg = _as_seg(seg, q.device)
    _check("flash_bwd_dkv_cuda", q, k, v, do, lse, delta, bias=bias,
           dropout_p=dropout_p, seed_arr=seed_arr, seg=seg)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    dk = torch.empty((b, sk, h, d), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, sk, h, d), dtype=v.dtype, device=v.device)
    if dk.numel() == 0:
        return dk, dv
    if sq == 0:
        return dk.zero_(), dv.zero_()
    bptr, bst = _bias_args(bias)
    sptr, tail = _mode_args(q, dropout_p, seed_arr)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _fn("flash_attention_bwd", "flash_bwd_dkv_launch", 14, 21)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            bptr, sptr, *_seg_args(seg), b, h, sq, sk, d,
            *_strides(q, k, v, do), *bst, float(scale), int(bool(causal)),
            *tail, stream)
    _raise_on(err, "flash attention dK/dV")
    _count(flash_bwd_dkv_cuda, q, bias, dropout_p, seg)
    return dk, dv


for _w in (flash_fwd_cuda, flash_bwd_dq_cuda, flash_bwd_dkv_cuda):
    for _mode in MODES:
        setattr(_w, mode_attr(*_mode), 0)


# ---------------- routers and the public functions ----------------

def _fwd(q, k, v, scale, causal, bias=None, dropout_p=0.0, seed_arr=None,
         seg=None):
    if use_kernel(q):
        return flash_fwd_cuda(q, k, v, scale, causal, bias, dropout_p,
                              seed_arr, seg)
    return flash_fwd_plain(q, k, v, scale, causal, bias, dropout_p, seed_arr,
                           seg)


def _grads(q, k, v, do, lse, delta, scale, causal, bias=None, dropout_p=0.0,
           seed_arr=None, seg=None):
    if use_kernel(q):
        dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale, causal, bias,
                               dropout_p, seed_arr, seg)
        dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, scale, causal,
                                    bias, dropout_p, seed_arr, seg)
        return dq, dk, dv
    return flash_block_grads_plain(q, k, v, do, lse, delta, scale, causal,
                                   bias, dropout_p, seed_arr, seg)


class _Flash(torch.autograd.Function):
    """Counterpart of ``_flash``, ``_flash_bias``, ``_flash_drop``,
    ``_flash_bias_drop`` (:617-705) and ``flash_attn_unpadded``'s ``run``
    (:796-816): the forward saves ``(q, k, v, out, lse, bias,
    seed_arr)`` and the segment ids; the backward computes ``delta`` of
    the (dropped) output and then runs dQ and dK/dV with the same key and
    ids, so they draw the forward's mask again. Neither the bias, the key
    nor the ids get a gradient (``_flash_bias_bwd`` and
    ``_flash_drop_bwd`` return zeros for them)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, seed_arr, scale, causal, dropout_p,
                seg=None):
        out, lse = _fwd(q, k, v, scale, causal, bias, dropout_p, seed_arr,
                        seg)
        ctx.save_for_backward(q, k, v, out, lse, bias, seed_arr)
        ctx.scale, ctx.causal, ctx.dropout_p = scale, causal, dropout_p
        ctx.seg = seg
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, bias, seed_arr = ctx.saved_tensors
        do = do.contiguous()
        dq, dk, dv = _grads(q, k, v, do, lse, flash_delta(do, out),
                            ctx.scale, ctx.causal, bias, ctx.dropout_p,
                            seed_arr, ctx.seg)
        return dq, dk, dv, None, None, None, None, None, None


def _scale(q, scale):
    return float(scale) if scale is not None else 1.0 / math.sqrt(
        q.shape[-1])


def _compact(m: torch.Tensor) -> torch.Tensor:
    """``m`` without its broadcast (stride-0) dimensions, each cut to
    size 1: a conversion then touches the distinct values only."""
    for dim in range(m.dim()):
        if m.stride(dim) == 0 and m.shape[dim] > 1:
            m = m.narrow(dim, 0, 1)
    return m


def pad_bias(bias, b, h, sq, sk) -> torch.Tensor:
    """Counterpart of ``_pad_bias`` (:268-288) without the padding to
    whole blocks (the kernels mask ragged edges themselves): the bias as
    fp32 ``[B, H, sq, sk]`` with ``B`` in ``{1, b}`` and ``H`` in
    ``{1, h}``; ranks ``[sq, sk]``, ``[b, sq, sk]`` (per batch) and
    ``[b|1, h|1, sq, sk]``. A broadcast dimension stays a stride-0 view
    and is converted once. Raises ValueError on another shape."""
    if bias.dim() == 2:
        bias = bias[None, None]
    elif bias.dim() == 3:
        bias = bias[:, None]
    elif bias.dim() != 4:
        raise ValueError(f"attn_mask rank {bias.dim()} unsupported: expected "
                         f"[sq,sk], [b,sq,sk] or [b,h|1,sq,sk]")
    B, H = bias.shape[:2]
    if B not in (1, b) or H not in (1, h) or tuple(bias.shape[2:]) != (sq,
                                                                     sk):
        raise ValueError(f"attn_mask shape {tuple(bias.shape)} does not "
                         f"broadcast to [{b}, {h}, {sq}, {sk}]")
    if bias.dtype != torch.float32:
        bias = _compact(bias).float().expand(bias.shape)
    return bias


def attn_bias(attn_mask, q, k) -> torch.Tensor:
    """The additive fp32 bias of ``flash_attention(attn_mask=...)``
    (:731-736): a bool mask becomes 0 where True and -1e30 where False;
    the result carries no gradient (``stop_gradient``)."""
    m = attn_mask.detach()
    if m.dtype == torch.bool:   # on the device: no host-to-device copy
        keep = _compact(m)
        m = torch.zeros(keep.shape, dtype=torch.float32,
                        device=m.device).masked_fill_(~keep, NEG) \
            .expand(m.shape)
    return pad_bias(m, q.shape[0], q.shape[2], q.shape[1], k.shape[1])


def seed_pair(q, fixed_seed_offset=None, generator=None) -> torch.Tensor:
    """The dropout key, int64 ``[2]`` (seed, offset) on q's device:
    ``fixed_seed_offset`` taken as it is (each word modulo 2**32, as the
    JAX package takes it as int32), else two words drawn from
    ``generator`` (its device's default generator when None), as
    ``flash_attention`` (:738-741) draws ``seed_arr`` from ``next_key()``.
    A draw on the generator's device never waits for the host."""
    if fixed_seed_offset is not None:
        words = [int(x) & 0xFFFFFFFF for x in fixed_seed_offset]
        if len(words) != 2:
            raise ValueError(f"fixed_seed_offset must be (seed, offset); "
                             f"got {fixed_seed_offset!r}")
        return torch.tensor(words, dtype=torch.int64, device=q.device)
    dev = generator.device if generator is not None else q.device
    return torch.randint(0, 1 << 32, (2,), generator=generator, device=dev,
                         dtype=torch.int64).to(q.device)


def flash_attention(q, k, v, causal: bool = False, scale: float | None = None,
                    attn_mask=None, dropout_p: float = 0.0,
                    fixed_seed_offset=None, generator=None):
    """Differentiable flash attention; layout ``[b, s, h, d]``, k and v
    with q's head count. ``attn_mask``: an additive float mask or a bool
    one (True keeps), ``[sq, sk]``, ``[b, sq, sk]`` or
    ``[b|1, h|1, sq, sk]``, applied inside the kernels and given no
    gradient. ``dropout_p > 0``: in-kernel dropout of the attention
    probabilities, its keep mask keyed on ``fixed_seed_offset`` or on two
    words drawn from ``generator`` (:seed_pair), drawn again by the
    backward, never stored."""
    dropout_p = float(dropout_p)
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"dropout_p must lie in [0, 1); got {dropout_p}")
    bias = None if attn_mask is None else attn_bias(attn_mask, q, k)
    seed_arr = (seed_pair(q, fixed_seed_offset, generator) if dropout_p
                else None)
    return _Flash.apply(q, k, v, bias, seed_arr, _scale(q, scale),
                        bool(causal), dropout_p)


def flash_attention_with_lse(q, k, v, causal: bool = False,
                             scale: float | None = None):
    """Forward only: ``(out, lse)`` (counterpart: :756)."""
    return _fwd(q, k, v, _scale(q, scale), bool(causal))


def flash_block_grads(q, k, v, do, lse, delta, *, scale, causal, seg=None,
                      bias=None, dropout_p=0.0, seed_arr=None):
    """``(dq, dk, dv)`` given the row statistics (counterpart: :478); a
    ``bias`` is taken as ``_pad_bias`` takes it (cast to fp32); with
    ``dropout_p > 0``, ``seed_arr`` is the forward's key (an int64
    ``[2]`` tensor or a (seed, offset) pair); ``seg`` is a ``(seg_q,
    seg_k)`` pair of per-token ids (or a :class:`SegIds`). Segment ids
    with a bias or dropout raise ValueError: the kernels have no such
    mode, as no path of the JAX package combines them."""
    dropout_p = float(dropout_p)
    if seg is not None:
        if bias is not None or dropout_p:
            raise ValueError(f"flash_block_grads: {_SEG_ALONE}")
        seg = _as_seg(seg, q.device)
    if bias is not None:
        bias = pad_bias(bias.detach(), q.shape[0], q.shape[2], q.shape[1],
                        k.shape[1])
    if dropout_p:
        if seed_arr is None:
            raise ValueError("flash_block_grads: dropout needs the "
                             "forward's seed_arr")
        if not isinstance(seed_arr, torch.Tensor):
            seed_arr = seed_pair(q, seed_arr)
        elif seed_arr.dtype != torch.int64 or seed_arr.device != q.device:
            seed_arr = seed_pair(q, seed_arr.tolist())
    return _grads(q, k, v, do, lse, delta, float(scale), bool(causal), bias,
                  dropout_p, seed_arr if dropout_p else None, seg)


def _cu(cu) -> np.ndarray:
    if isinstance(cu, torch.Tensor):
        cu = cu.detach().cpu().numpy()
    return np.asarray(cu, np.int64).reshape(-1)


def flash_attn_unpadded(q, k, v, cu_seqlens_q, cu_seqlens_k,
                        causal: bool = False, scale: float | None = None):
    """Varlen flash attention over packed sequences (counterpart:
    ``flash_attn_unpadded``, flash_attention.py:765-818): q ``[total_q,
    h, d]``, k and v ``[total_k, h, d]`` (q's head count), b sequences
    packed along dim 0 with host-known cumulative lengths
    ``cu_seqlens_q`` / ``cu_seqlens_k`` ``[b + 1]`` (lists, arrays or
    tensors). A token attends only within its own sequence; ``causal``
    adds per-sequence causal masking, which needs equal query and key
    lengths per sequence: then the packings align and the global causal
    mask restricted to one segment is that sequence's own. One launch of
    each kernel (the segment mode) for the whole batch, no padding.
    Differentiable in q, k and v. Raises ValueError as the JAX function
    does."""
    cu_q, cu_k = _cu(cu_seqlens_q), _cu(cu_seqlens_k)
    if causal and not np.array_equal(np.diff(cu_q), np.diff(cu_k)):
        raise ValueError("causal varlen requires seqlen_q == seqlen_k "
                         "per sequence")
    total_q, h, d = q.shape
    total_k = k.shape[0]
    if total_q != cu_q[-1] or total_k != cu_k[-1]:
        raise ValueError("cu_seqlens totals do not match packed lengths")
    # ids as the JAX function makes them: a zero-length segment owns no
    # token and its id is skipped
    seg = seg_ids(np.searchsorted(cu_q, np.arange(total_q), side="right") - 1,
                  np.searchsorted(cu_k, np.arange(total_k), side="right") - 1,
                  q.device)
    out = _Flash.apply(q[None], k[None], v[None], None, None,
                       _scale(q, scale), bool(causal), 0.0, seg)
    return out[0]
