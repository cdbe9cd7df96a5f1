"""Kernel 1: row RMSNorm (CUDA, ``csrc/rms_norm.cu``).

Replaces ``paddle_tpu/ops/pallas/fused_norm.py::_rms_fwd_pallas`` (the
``pallas_call`` behind ``fused_rms_norm``). See the source for what
bounds it on the H100 and how the design answers that.

- :func:`rms_norm_plain` — the plain PyTorch version (CPU path, tests,
  and the yardstick the kernel is held against on the card);
- :func:`rms_norm_cuda` — the kernel's wrapper: launches on a CUDA
  tensor or raises; ``rms_norm_cuda.launches`` counts its launches;
- :func:`rms_norm` — the differentiable router the model calls: its
  forward is the kernel on a CUDA tensor and the plain version on a CPU
  one; its backward is the closed form of the JAX package's ``_rms_bwd``
  (fused_norm.py:80), an XLA composition there and a torch composition
  here (:func:`rms_norm_bwd_plain`).
"""

from __future__ import annotations

import ctypes

import torch

from .build import library
from .routing import use_kernel

__all__ = ["rms_norm", "rms_norm_plain", "rms_norm_cuda",
           "rms_norm_bwd_plain", "MAX_D"]

MAX_D = 8192
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def rms_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """fp32 statistics, fp32 weight, one rounding to x's dtype — the
    arithmetic of the Pallas kernel (fused_norm.py:27)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def _fn():
    fn = library("rms_norm").rms_norm_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int, ctypes.c_float,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def rms_norm_cuda(x: torch.Tensor, weight: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """Launch the CUDA kernel on ``x`` ``[..., d]``; raises on anything
    it does not take (device, dtype, d > MAX_D, a strided row)."""
    d = x.shape[-1]
    if not (x.is_cuda and weight.is_cuda and x.device == weight.device):
        raise ValueError("rms_norm_cuda needs x and weight on one CUDA "
                         "device")
    if x.dtype not in _DTYPE_CODE or weight.dtype != x.dtype:
        raise ValueError(f"rms_norm_cuda takes float32/bfloat16 with the "
                         f"weight in x's dtype; got x {x.dtype}, weight "
                         f"{weight.dtype}")
    if weight.shape != (d,) or not 0 < d <= MAX_D:
        raise ValueError(f"rms_norm_cuda takes d in [1, {MAX_D}] and a "
                         f"[d] weight; got x {tuple(x.shape)}, weight "
                         f"{tuple(weight.shape)}")
    x2 = x.reshape(-1, d)
    if not x2.is_contiguous():
        raise ValueError("rms_norm_cuda needs contiguous rows")
    w = weight.contiguous()
    y = torch.empty_like(x2)
    if x2.shape[0] == 0:
        return y.reshape(x.shape)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _fn()(x2.data_ptr(), w.data_ptr(), y.data_ptr(), x2.shape[0],
                    d, float(eps), _DTYPE_CODE[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"rms_norm kernel launch failed: CUDA error "
                           f"{err}")
    rms_norm_cuda.launches += 1
    return y.reshape(x.shape)


rms_norm_cuda.launches = 0


def rms_norm_bwd_plain(x, weight, g, eps: float):
    """``(dx, dw)`` of ``_rms_bwd`` (fused_norm.py:80-94): fp32 row
    statistics; dx in x's dtype, dw in the weight's."""
    xf = x.float().reshape(-1, x.shape[-1])
    gf = g.float().reshape(xf.shape)
    inv = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    xhat = xf * inv
    gw = gf * weight.float()[None, :]
    dx = (gw - xhat * (gw * xhat).mean(dim=-1, keepdim=True)) * inv
    dw = (gf * xhat).sum(dim=0)
    return dx.reshape(x.shape).to(x.dtype), dw.to(weight.dtype)


def _forward(x, weight, eps):
    if use_kernel(x):
        return rms_norm_cuda(x, weight, eps)
    return rms_norm_plain(x, weight, eps)


class _RMSNorm(torch.autograd.Function):
    """Counterpart of ``_rms`` (``jax.custom_vjp``, fused_norm.py:71):
    saves ``(x, weight)`` and recomputes the statistics in the backward."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _forward(x, weight, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw = rms_norm_bwd_plain(x, weight, g, ctx.eps)
        return dx, dw, None


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float) -> torch.Tensor:
    """RMSNorm over the last axis; differentiable in x and weight. When
    no gradient is wanted (serving runs under ``torch.no_grad()``) the
    forward is called directly, without the autograd Function's host
    cost."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return _RMSNorm.apply(x, weight, float(eps))
    return _forward(x, weight, float(eps))
