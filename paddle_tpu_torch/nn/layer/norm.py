"""RMSNorm and LayerNorm (counterpart: paddle_tpu/nn/layer/norm.py)."""

from __future__ import annotations

import torch
from torch import nn

from .. import functional as F

__all__ = ["RMSNorm", "LayerNorm"]


class RMSNorm(nn.Module):
    """Routes to the hand-written kernel on the card via F.rms_norm
    (counterpart: norm.py:123)."""

    def __init__(self, hidden_size: int, epsilon: float = 1e-6, *,
                 device=None, dtype=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.empty((hidden_size,), device=device,
                                               dtype=dtype))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.rms_norm(x, self.weight, self.epsilon)


class LayerNorm(nn.Module):
    """LayerNorm with scale and shift over the trailing
    ``normalized_shape`` (counterpart: norm.py:99-120); weight ones and
    bias zeros. Over one axis it routes to the hand-written kernel on the
    card via F.layer_norm."""

    def __init__(self, normalized_shape, epsilon: float = 1e-5, *,
                 device=None, dtype=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.empty(self.normalized_shape,
                                               device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(self.normalized_shape,
                                             device=device, dtype=dtype))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape, self.weight,
                            self.bias, self.epsilon)
