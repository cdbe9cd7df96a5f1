"""Normalization functionals (counterpart: paddle_tpu/nn/functional/norm.py)."""

from __future__ import annotations

import torch

from ...ops.kernels.layer_norm import layer_norm as _ln_route
from ...ops.kernels.rms_norm import rms_norm as _rms_route

__all__ = ["layer_norm", "rms_norm"]


def layer_norm(x: torch.Tensor, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the trailing ``normalized_shape`` axes (counterpart:
    norm.py:14-35). With a weight and a bias, one normalised axis and
    ``x.dim() >= 2`` it takes the fused route (ops/kernels/layer_norm.py:
    the hand-written kernel for a CUDA tensor, its plain version for a
    CPU one); otherwise the fp32 composition below. Both keep fp32
    statistics and round once to x's dtype."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    axes = tuple(range(x.dim() - len(normalized_shape), x.dim()))
    if (weight is not None and bias is not None and len(axes) == 1
            and x.dim() >= 2):
        return _ln_route(x, weight, bias, epsilon)
    xf = x.float()
    mean = xf.mean(dim=axes, keepdim=True)
    var = (xf - mean).square().mean(dim=axes, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + epsilon)
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor | None = None,
             epsilon: float = 1e-6) -> torch.Tensor:
    """RMSNorm (counterpart: norm.py:39). With a weight, a CUDA tensor
    takes the hand-written kernel (ops/kernels/rms_norm.py) and a CPU
    tensor its plain version; both keep fp32 statistics and round once
    to x's dtype."""
    if weight is not None:
        return _rms_route(x, weight, epsilon)
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + epsilon)).to(x.dtype)
