"""Kernel 11: row LayerNorm with scale and shift (CUDA,
``csrc/layer_norm.cu``).

Replaces ``paddle_tpu/ops/pallas/fused_norm.py::_ln_fwd_pallas`` (its
``pallas_call`` at :127, kernel ``_ln_kernel`` :34-43), the forward
behind ``fused_layer_norm``. See the source for what bounds it on the
H100 and how the design answers that.

- :func:`layer_norm_plain` — the plain PyTorch version (CPU path, tests,
  and what the kernel is held against on the card): the Pallas
  arithmetic, fp32 x, weight and bias, the mean first and then the
  variance of the centred values, ``rsqrt(var + eps)``, one rounding to
  x's dtype;
- :func:`layer_norm_cuda` — the kernel's wrapper: launches on CUDA
  tensors or raises; ``layer_norm_cuda.launches`` counts its launches;
- :func:`layer_norm` — the differentiable router the model calls: its
  forward is the kernel on a CUDA tensor and the plain version on a CPU
  one; its backward is the closed form of the JAX package's ``_ln_bwd``
  (fused_norm.py:149-163), an XLA composition there and a torch
  composition here (:func:`layer_norm_bwd_plain`).
"""

from __future__ import annotations

import ctypes

import torch

from .build import library
from .routing import use_kernel

__all__ = ["layer_norm", "layer_norm_plain", "layer_norm_cuda",
           "layer_norm_bwd_plain", "MAX_D"]

MAX_D = 4096
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VEC = {torch.float32: 4, torch.bfloat16: 8}     # elements in 16 bytes


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float) -> torch.Tensor:
    """``_ln_kernel``'s arithmetic over the last axis of ``x``."""
    xf = x.float()
    xc = xf - xf.mean(dim=-1, keepdim=True)
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return (xc * torch.rsqrt(var + eps) * weight.float()
            + bias.float()).to(x.dtype)


def _fn():
    fn = library("layer_norm").layer_norm_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int64, ctypes.c_int, ctypes.c_float, ctypes.c_int,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def layer_norm_cuda(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, eps: float) -> torch.Tensor:
    """Launch the CUDA kernel on ``x`` ``[..., d]``; raises ValueError on
    anything it does not take: tensors off one CUDA device, a dtype other
    than float32/bfloat16 shared by all three, ``d`` above MAX_D or not a
    multiple of the elements in 16 bytes (8 bf16, 4 fp32), strided rows,
    or storage that is not 16-byte aligned."""
    d = x.shape[-1]
    if not all(t.is_cuda and t.device == x.device for t in (x, weight, bias)):
        raise ValueError("layer_norm_cuda needs x, weight and bias on one "
                         "CUDA device")
    if x.dtype not in _DTYPE_CODE or not x.dtype == weight.dtype \
            == bias.dtype:
        raise ValueError(f"layer_norm_cuda takes float32/bfloat16 with the "
                         f"weight and bias in x's dtype; got x {x.dtype}, "
                         f"weight {weight.dtype}, bias {bias.dtype}")
    if (weight.shape != (d,) or bias.shape != (d,) or not 0 < d <= MAX_D
            or d % _VEC[x.dtype]):
        raise ValueError(f"layer_norm_cuda takes d in [1, {MAX_D}], a "
                         f"multiple of {_VEC[x.dtype]} for {x.dtype}, and "
                         f"[d] weight and bias; got x {tuple(x.shape)}, "
                         f"weight {tuple(weight.shape)}, bias "
                         f"{tuple(bias.shape)}")
    x2 = x.reshape(-1, d)
    w, b = weight.contiguous(), bias.contiguous()
    if not x2.is_contiguous() or any(t.data_ptr() % 16 for t in (x2, w, b)):
        raise ValueError("layer_norm_cuda needs contiguous rows and 16-byte "
                         "aligned x, weight and bias")
    y = torch.empty_like(x2)
    if x2.shape[0] == 0:
        return y.reshape(x.shape)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _fn()(x2.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                    x2.shape[0], d, float(eps), _DTYPE_CODE[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"layer_norm kernel launch failed: CUDA error "
                           f"{err}")
    layer_norm_cuda.launches += 1
    return y.reshape(x.shape)


layer_norm_cuda.launches = 0


def layer_norm_bwd_plain(x, weight, g, eps: float, bias_dtype):
    """``(dx, dw, db)`` of ``_ln_bwd`` (fused_norm.py:149-163): fp32 row
    statistics recomputed from x; dx in x's dtype, dw in the weight's,
    db in ``bias_dtype``."""
    d = x.shape[-1]
    xf = x.float().reshape(-1, d)
    gf = g.float().reshape(xf.shape)
    xc = xf - xf.mean(dim=-1, keepdim=True)
    inv = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    xhat = xc * inv
    gw = gf * weight.float()[None, :]
    dx = (gw - gw.mean(dim=-1, keepdim=True)
          - xhat * (gw * xhat).mean(dim=-1, keepdim=True)) * inv
    dw = (gf * xhat).sum(dim=0)
    db = gf.sum(dim=0)
    return (dx.reshape(x.shape).to(x.dtype), dw.to(weight.dtype),
            db.to(bias_dtype))


def _forward(x, weight, bias, eps):
    if use_kernel(x):
        return layer_norm_cuda(x, weight, bias, eps)
    return layer_norm_plain(x, weight, bias, eps)


class _LayerNorm(torch.autograd.Function):
    """Counterpart of ``_ln`` (``jax.custom_vjp``, fused_norm.py:140):
    saves ``(x, weight)`` and recomputes the statistics in the backward."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps, ctx.bias_dtype = eps, bias.dtype
        return _forward(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw, db = layer_norm_bwd_plain(x, weight, g, ctx.eps,
                                          ctx.bias_dtype)
        return dx, dw, db, None


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm over the last axis with scale and shift; differentiable
    in x, weight and bias. When no gradient is wanted the forward is
    called directly, without the autograd Function's host cost."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, weight, bias)):
        return _LayerNorm.apply(x, weight, bias, float(eps))
    return _forward(x, weight, bias, float(eps))
