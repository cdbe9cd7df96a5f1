"""Kernels 3-5: flash attention forward, dQ and dK/dV (CUDA,
``csrc/flash_attention_fwd.cu`` and ``csrc/flash_attention_bwd.cu``).

Replaces ``paddle_tpu/ops/pallas/flash_attention.py``: ``_fwd`` (its
``pallas_call`` at :242) and the two ``pallas_call``s of
``flash_block_grads`` (dQ :558, dK/dV :590), causal and non-causal, with
and without the additive bias (``has_bias``). See the sources for what
bounds them on the H100 and how the designs answer that. Layout
``[batch, seq, heads, head_dim]`` as in the JAX package; ``lse`` and
``delta`` are fp32 ``[batch, heads, seq_q]``; a bias is fp32
``[b|1, h|1, sq, sk]``, added to the scaled scores before the softmax.

- :func:`flash_fwd_plain`, :func:`flash_block_grads_plain` — the plain
  PyTorch versions (CPU path, tests, and what the kernels are held
  against on the card). They keep the Pallas arithmetic: fp32 q, k, v;
  the forward scales q before the QK product, the backward scales the
  product after; masked scores take the finite ``-1e30`` and the
  subtracted max is clamped at ``-1e25``, so a fully masked row gives
  ``out = 0`` and ``lse = -1e30``; causal masks align bottom-right
  (row r sees columns ``<= r + sk - sq``); a bias is added after the
  causal mask, as in the Pallas kernels.
- :func:`flash_fwd_cuda`, :func:`flash_bwd_dq_cuda`,
  :func:`flash_bwd_dkv_cuda` — the kernels' wrappers: they launch on
  bf16 CUDA tensors or raise outside :func:`kernel_gate`; each counts its
  no-bias launches in ``.launches`` and its bias-mode launches in
  ``.bias_launches``. The kernels take bf16 only: their products run on
  bf16 tensor cores, and an fp32 input rounded to bf16 on the way in
  would silently lose the precision the plain versions keep. The bias
  goes to the kernels through its strides, so a broadcast dimension
  (stride 0) is never materialised.
- :func:`flash_attention` (differentiable in q, k and v; the mask is
  not), :func:`flash_attention_with_lse` and :func:`flash_block_grads`
  — the public functions, with the JAX package's signatures. A CPU
  tensor, or a CUDA tensor inside ``plain_reference()``, takes the plain
  versions.

Not ported: the segment-id (``flash_attn_unpadded``), in-kernel dropout
and fp32 modes (ROADMAP.md B1); the public functions raise on the first
two, and the wrappers on fp32 inputs.
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
           "flash_delta", "kernel_gate", "bias_gate", "pad_bias",
           "attn_bias", "HEAD_DIMS"]

HEAD_DIMS = (64, 128)
NEG = -1e30          # the Pallas kernels' finite mask value
_CLAMP = -1e25       # clamp of the subtracted max / lse (fully masked rows)
_UNPORTED = ("the segment-id and in-kernel dropout modes of flash "
             "attention (and fp32 flash on the card) are not ported yet "
             "(ROADMAP.md B1)")


def _causal_keep(sq: int, sk: int, device) -> torch.Tensor:
    """[sq, sk] bool: row r keeps columns <= r + (sk - sq)."""
    rows = torch.arange(sq, device=device)[:, None]
    cols = torch.arange(sk, device=device)[None, :]
    return rows + (sk - sq) >= cols


def flash_fwd_plain(q, k, v, scale: float, causal: bool, bias=None):
    """``(out, lse)`` of ``_fwd`` / ``_fwd_kernel`` (flash_attention.py:96-265)
    computed in one block: out in q's dtype, lse fp32 ``[b, h, sq]``;
    ``bias`` (fp32, broadcastable to ``[b, h, sq, sk]``) is added after
    ``(q * scale) k`` and the causal mask (:146-148)."""
    sq, sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    if causal:
        s = torch.where(_causal_keep(sq, sk, q.device), s,
                        torch.tensor(NEG, device=q.device))
    if bias is not None:
        s = s + bias.float()
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
                            causal: bool, bias=None):
    """``(dq, dk, dv)`` of ``flash_block_grads`` (:478-612) in one block:
    P recomputed from ``lse`` (``bias`` added after ``(q k) * scale`` and
    the causal mask, :363-374 and :437), ``dS = P * (dP - delta) *
    scale``; dq in q's dtype, dk and dv in k's and v's."""
    sq, sk = q.shape[1], k.shape[1]
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if causal:
        s = torch.where(_causal_keep(sq, sk, q.device), s,
                        torch.tensor(NEG, device=q.device))
    if bias is not None:
        s = s + bias.float()
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


def _check(name, *args, bias=None):
    why = kernel_gate(*args)
    if why is None and bias is not None:
        why = bias_gate(bias, args[0], args[1])
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


def _bias_args(bias):
    """The bias pointer (None: no bias) and its four element strides, 0 on
    a dimension of size 1 (broadcast)."""
    if bias is None:
        return None, [0, 0, 0, 0]
    return bias.data_ptr(), [0 if n == 1 else st
                             for n, st in zip(bias.shape, bias.stride())]


def _count(fn, bias):
    if bias is None:
        fn.launches += 1
    else:
        fn.bias_launches += 1


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def flash_fwd_cuda(q, k, v, scale: float, causal: bool, bias=None):
    """Launch the forward kernel: ``(out [b, sq, h, d] in q's dtype,
    lse fp32 [b, h, sq])``; with ``bias`` its bias mode. Raises
    ValueError outside :func:`kernel_gate` and :func:`bias_gate`."""
    _check("flash_fwd_cuda", q, k, v, bias=bias)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse.fill_(NEG)
    bptr, bst = _bias_args(bias)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _fn("flash_attention_fwd", "flash_fwd_launch", 6, 18)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), bptr, b, h, sq, sk, d, *_strides(q, k, v), *bst,
            float(scale), int(bool(causal)), stream)
    _raise_on(err, "flash attention forward")
    _count(flash_fwd_cuda, bias)
    return out, lse


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale: float, causal: bool,
                      bias=None):
    """Launch the dQ kernel (with ``bias``: its bias mode); dq in q's
    dtype, contiguous."""
    _check("flash_bwd_dq_cuda", q, k, v, do, lse, delta, bias=bias)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    if dq.numel() == 0:
        return dq
    if sk == 0:
        return dq.zero_()
    bptr, bst = _bias_args(bias)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _fn("flash_attention_bwd", "flash_bwd_dq_launch", 8, 21)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bptr, b, h, sq,
            sk, d, *_strides(q, k, v, do), *bst, float(scale),
            int(bool(causal)), stream)
    _raise_on(err, "flash attention dQ")
    _count(flash_bwd_dq_cuda, bias)
    return dq


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, scale: float,
                       causal: bool, bias=None):
    """Launch the dK/dV kernel (with ``bias``: its bias mode); dk, dv in
    k's dtype, contiguous."""
    _check("flash_bwd_dkv_cuda", q, k, v, do, lse, delta, bias=bias)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    dk = torch.empty((b, sk, h, d), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, sk, h, d), dtype=v.dtype, device=v.device)
    if dk.numel() == 0:
        return dk, dv
    if sq == 0:
        return dk.zero_(), dv.zero_()
    bptr, bst = _bias_args(bias)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _fn("flash_attention_bwd", "flash_bwd_dkv_launch", 9, 21)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            bptr, b, h, sq, sk, d, *_strides(q, k, v, do), *bst,
            float(scale), int(bool(causal)), stream)
    _raise_on(err, "flash attention dK/dV")
    _count(flash_bwd_dkv_cuda, bias)
    return dk, dv


for _w in (flash_fwd_cuda, flash_bwd_dq_cuda, flash_bwd_dkv_cuda):
    _w.launches = 0
    _w.bias_launches = 0


# ---------------- routers and the public functions ----------------

def _fwd(q, k, v, scale, causal, bias=None):
    if use_kernel(q):
        return flash_fwd_cuda(q, k, v, scale, causal, bias)
    return flash_fwd_plain(q, k, v, scale, causal, bias)


def _grads(q, k, v, do, lse, delta, scale, causal, bias=None):
    if use_kernel(q):
        dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale, causal, bias)
        dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, scale, causal,
                                    bias)
        return dq, dk, dv
    return flash_block_grads_plain(q, k, v, do, lse, delta, scale, causal,
                                   bias)


class _Flash(torch.autograd.Function):
    """Counterpart of ``_flash`` and ``_flash_bias`` (:617-653): the
    forward saves ``(q, k, v, out, lse, bias)``; the backward computes
    ``delta`` and then runs dQ and dK/dV. The bias gets no gradient
    (``_flash_bias_bwd`` returns zeros for it)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, causal):
        out, lse = _fwd(q, k, v, scale, causal, bias)
        ctx.save_for_backward(q, k, v, out, lse, bias)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, bias = ctx.saved_tensors
        do = do.contiguous()
        dq, dk, dv = _grads(q, k, v, do, lse, flash_delta(do, out),
                            ctx.scale, ctx.causal, bias)
        return dq, dk, dv, None, None, None


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


def flash_attention(q, k, v, causal: bool = False, scale: float | None = None,
                    attn_mask=None, dropout_p: float = 0.0):
    """Differentiable flash attention; layout ``[b, s, h, d]``, k and v
    with q's head count. ``attn_mask``: an additive float mask or a bool
    one (True keeps), ``[sq, sk]``, ``[b, sq, sk]`` or
    ``[b|1, h|1, sq, sk]``, applied inside the kernels and given no
    gradient."""
    if dropout_p:
        raise NotImplementedError(_UNPORTED)
    bias = None if attn_mask is None else attn_bias(attn_mask, q, k)
    return _Flash.apply(q, k, v, bias, _scale(q, scale), bool(causal))


def flash_attention_with_lse(q, k, v, causal: bool = False,
                             scale: float | None = None):
    """Forward only: ``(out, lse)`` (counterpart: :756)."""
    return _fwd(q, k, v, _scale(q, scale), bool(causal))


def flash_block_grads(q, k, v, do, lse, delta, *, scale, causal, seg=None,
                      bias=None, dropout_p=0.0, seed_arr=None):
    """``(dq, dk, dv)`` given the row statistics (counterpart: :478); a
    ``bias`` is taken as ``_pad_bias`` takes it (cast to fp32)."""
    if seg is not None or dropout_p or seed_arr is not None:
        raise NotImplementedError(_UNPORTED)
    if bias is not None:
        bias = pad_bias(bias.detach(), q.shape[0], q.shape[2], q.shape[1],
                        k.shape[1])
    return _grads(q, k, v, do, lse, delta, float(scale), bool(causal), bias)
