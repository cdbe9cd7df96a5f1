"""Kernels 3-5: flash attention forward, dQ and dK/dV (CUDA,
``csrc/flash_attention_fwd.cu`` and ``csrc/flash_attention_bwd.cu``).

Replaces ``paddle_tpu/ops/pallas/flash_attention.py``: ``_fwd`` (its
``pallas_call`` at :242) and the two ``pallas_call``s of
``flash_block_grads`` (dQ :558, dK/dV :590), causal and non-causal. See
the sources for what bounds them on the H100 and how the designs answer
that. Layout ``[batch, seq, heads, head_dim]`` as in the JAX package;
``lse`` and ``delta`` are fp32 ``[batch, heads, seq_q]``.

- :func:`flash_fwd_plain`, :func:`flash_block_grads_plain` — the plain
  PyTorch versions (CPU path, tests, and what the kernels are held
  against on the card). They keep the Pallas arithmetic: fp32 q, k, v;
  the forward scales q before the QK product, the backward scales the
  product after; masked scores take the finite ``-1e30`` and the
  subtracted max is clamped at ``-1e25``, so a fully masked row gives
  ``out = 0`` and ``lse = -1e30``; causal masks align bottom-right
  (row r sees columns ``<= r + sk - sq``).
- :func:`flash_fwd_cuda`, :func:`flash_bwd_dq_cuda`,
  :func:`flash_bwd_dkv_cuda` — the kernels' wrappers: they launch on
  bf16 CUDA tensors or raise outside :func:`kernel_gate`; each counts its
  launches in ``.launches``. The kernels take bf16 only: their products
  run on bf16 tensor cores, and an fp32 input rounded to bf16 on the way
  in would silently lose the precision the plain versions keep.
- :func:`flash_attention` (differentiable), :func:`flash_attention_with_lse`
  and :func:`flash_block_grads` — the public functions, with the JAX
  package's signatures. A CPU tensor, or a CUDA tensor inside
  ``plain_reference()``, takes the plain versions.

Not ported: the additive-bias, segment-id (``flash_attn_unpadded``) and
dropout modes; the public functions raise on them.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .build import library
from .routing import use_kernel

__all__ = ["flash_attention", "flash_attention_with_lse",
           "flash_block_grads", "flash_fwd_plain", "flash_block_grads_plain",
           "flash_fwd_cuda", "flash_bwd_dq_cuda", "flash_bwd_dkv_cuda",
           "flash_delta", "kernel_gate", "HEAD_DIMS"]

HEAD_DIMS = (64, 128)
NEG = -1e30          # the Pallas kernels' finite mask value
_CLAMP = -1e25       # clamp of the subtracted max / lse (fully masked rows)
_UNPORTED = ("the bias, segment-id and dropout modes of flash attention "
             "are not ported yet (ROADMAP.md B1)")


def _causal_keep(sq: int, sk: int, device) -> torch.Tensor:
    """[sq, sk] bool: row r keeps columns <= r + (sk - sq)."""
    rows = torch.arange(sq, device=device)[:, None]
    cols = torch.arange(sk, device=device)[None, :]
    return rows + (sk - sq) >= cols


def flash_fwd_plain(q, k, v, scale: float, causal: bool):
    """``(out, lse)`` of ``_fwd`` / ``_fwd_kernel`` (flash_attention.py:96-265)
    computed in one block: out in q's dtype, lse fp32 ``[b, h, sq]``."""
    sq, sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    if causal:
        s = torch.where(_causal_keep(sq, sk, q.device), s,
                        torch.tensor(NEG, device=q.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m.clamp(min=_CLAMP))
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    out = out / l_safe.permute(0, 2, 1, 3)
    lse = (m + torch.log(l_safe))[..., 0]
    return out.to(q.dtype), lse


def flash_delta(do, out) -> torch.Tensor:
    """delta = rowsum(dO * O) in fp32 ``[b, h, sq]`` (``_delta`` :466)."""
    return (do.float() * out.float()).sum(dim=-1).transpose(1, 2) \
        .contiguous()


def flash_block_grads_plain(q, k, v, do, lse, delta, scale: float,
                            causal: bool):
    """``(dq, dk, dv)`` of ``flash_block_grads`` (:478-612) in one block:
    P recomputed from ``lse``, ``dS = P * (dP - delta) * scale``; dq in
    q's dtype, dk and dv in k's and v's."""
    sq, sk = q.shape[1], k.shape[1]
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if causal:
        s = torch.where(_causal_keep(sq, sk, q.device), s,
                        torch.tensor(NEG, device=q.device))
    p = torch.exp(s - lse.float().clamp(min=_CLAMP)[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta.float()[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------- the kernels' wrappers ----------------

def _rows_ok(t: torch.Tensor) -> bool:
    """16-byte vector loads of 8 consecutive elements: unit stride on d,
    the other strides multiples of 8, a 16-byte aligned start."""
    return (t.stride(3) == 1 and all(s % 8 == 0 for s in t.stride()[:3])
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
    if not q.dtype == k.dtype == v.dtype == torch.bfloat16:
        return (f"q, k, v must all be bfloat16 (the tensor cores' input "
                f"type; fp32 flash on the card is ROADMAP B1); got "
                f"{q.dtype}, {k.dtype}, {v.dtype}")
    if do is not None:
        if do.shape != q.shape or do.dtype != q.dtype:
            return "dO must have q's shape and dtype"
        for name, t in (("lse", lse), ("delta", delta)):
            if (t is None or t.dtype != torch.float32
                    or tuple(t.shape) != (b, h, sq) or not t.is_contiguous()):
                return f"{name} must be contiguous float32 [b, h, sq]"
    if not all(_rows_ok(t) for t in (q, k, v) + ((do,) if do is not None
                                                 else ())):
        return ("q, k, v (and dO) need unit stride on head_dim, strides "
                "that are multiples of 8 and 16-byte aligned storage")
    if b * h > 65535:
        return "at most 65535 batch*heads"
    return None


def _check(name, *args):
    why = kernel_gate(*args)
    if why is not None:
        raise ValueError(f"{name}: {why}")


def _fn(lib: str, sym: str, n_ptr: int, n_int: int):
    fn = getattr(library(lib), sym)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int64] * n_int
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _strides(*ts):
    return [s for t in ts for s in t.stride()[:3]]


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def flash_fwd_cuda(q, k, v, scale: float, causal: bool):
    """Launch the forward kernel: ``(out [b, sq, h, d] in q's dtype,
    lse fp32 [b, h, sq])``. Raises ValueError outside :func:`kernel_gate`."""
    _check("flash_fwd_cuda", q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse.fill_(NEG)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _fn("flash_attention_fwd", "flash_fwd_launch", 5, 14)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, h, sq, sk, d, *_strides(q, k, v),
            float(scale), int(bool(causal)), stream)
    _raise_on(err, "flash attention forward")
    flash_fwd_cuda.launches += 1
    return out, lse


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale: float, causal: bool):
    """Launch the dQ kernel; dq in q's dtype, contiguous."""
    _check("flash_bwd_dq_cuda", q, k, v, do, lse, delta)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    if dq.numel() == 0:
        return dq
    if sk == 0:
        return dq.zero_()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _fn("flash_attention_bwd", "flash_bwd_dq_launch", 7, 17)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, h, sq, sk,
            d, *_strides(q, k, v, do), float(scale), int(bool(causal)),
            stream)
    _raise_on(err, "flash attention dQ")
    flash_bwd_dq_cuda.launches += 1
    return dq


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, scale: float,
                       causal: bool):
    """Launch the dK/dV kernel; dk, dv in k's dtype, contiguous."""
    _check("flash_bwd_dkv_cuda", q, k, v, do, lse, delta)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    dk = torch.empty((b, sk, h, d), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, sk, h, d), dtype=v.dtype, device=v.device)
    if dk.numel() == 0:
        return dk, dv
    if sq == 0:
        return dk.zero_(), dv.zero_()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _fn("flash_attention_bwd", "flash_bwd_dkv_launch", 8, 17)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, h, sq, sk, d, *_strides(q, k, v, do), float(scale),
            int(bool(causal)), stream)
    _raise_on(err, "flash attention dK/dV")
    flash_bwd_dkv_cuda.launches += 1
    return dk, dv


flash_fwd_cuda.launches = 0
flash_bwd_dq_cuda.launches = 0
flash_bwd_dkv_cuda.launches = 0


# ---------------- routers and the public functions ----------------

def _fwd(q, k, v, scale, causal):
    if use_kernel(q):
        return flash_fwd_cuda(q, k, v, scale, causal)
    return flash_fwd_plain(q, k, v, scale, causal)


def _grads(q, k, v, do, lse, delta, scale, causal):
    if use_kernel(q):
        dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale, causal)
        dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, scale, causal)
        return dq, dk, dv
    return flash_block_grads_plain(q, k, v, do, lse, delta, scale, causal)


class _Flash(torch.autograd.Function):
    """Counterpart of ``_flash`` / ``_flash_fwd`` / ``_flash_bwd``
    (:617-632): the forward saves ``(q, k, v, out, lse)``; the backward
    computes ``delta`` and then runs dQ and dK/dV."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        out, lse = _fwd(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        dq, dk, dv = _grads(q, k, v, do, lse, flash_delta(do, out),
                            ctx.scale, ctx.causal)
        return dq, dk, dv, None, None


def _scale(q, scale):
    return float(scale) if scale is not None else 1.0 / math.sqrt(
        q.shape[-1])


def flash_attention(q, k, v, causal: bool = False, scale: float | None = None,
                    attn_mask=None, dropout_p: float = 0.0):
    """Differentiable flash attention; layout ``[b, s, h, d]``, k and v
    with q's head count."""
    if attn_mask is not None or dropout_p:
        raise NotImplementedError(_UNPORTED)
    return _Flash.apply(q, k, v, _scale(q, scale), bool(causal))


def flash_attention_with_lse(q, k, v, causal: bool = False,
                             scale: float | None = None):
    """Forward only: ``(out, lse)`` (counterpart: :756)."""
    return _fwd(q, k, v, _scale(q, scale), bool(causal))


def flash_block_grads(q, k, v, do, lse, delta, *, scale, causal, seg=None,
                      bias=None, dropout_p=0.0, seed_arr=None):
    """``(dq, dk, dv)`` given the row statistics (counterpart: :478)."""
    if seg is not None or bias is not None or dropout_p or \
            seed_arr is not None:
        raise NotImplementedError(_UNPORTED)
    return _grads(q, k, v, do, lse, delta, float(scale), bool(causal))
