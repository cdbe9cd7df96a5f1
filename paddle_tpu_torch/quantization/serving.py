"""Low-bit serving (counterpart: paddle_tpu/quantization/serving.py).

Two halves, aimed at the bytes a decode step reads:

- **int8 KV cache**: :class:`QuantizedKV` is what the paged pool holds
  when ``ServingEngine(kv_quant=True)``: symmetric absmax int8 codes and
  one fp32 scale per ``[..., head_dim]`` row. Rows are quantized once,
  when the model writes them into the pool, and every attention read
  dequantizes them to fp32 (the paged-decode kernel's int8 mode inside
  its page loop; the gather path before the grouped core).
- **int8 weight streaming**: :func:`quantize_for_serving` swaps a
  model's ``Linear`` layers (attention projections and MLP; the
  ``lm_head`` stays as it is) for :class:`Int8ServingLinear`, which
  keeps int8 codes and fp32 scales as buffers.

Error model: with ``scale = absmax / 127`` per row, each element's
quantization error is at most ``scale / 2``; a row that is exactly zero
gets scale 0 and dequantizes to exact zeros, so scrubbed pages stay
zero.
"""

from __future__ import annotations

import copy
import itertools
from typing import NamedTuple

import torch
from torch import nn

from . import _dequantize_weight, quantize_weight

__all__ = ["QuantizedKV", "KV_QMAX", "kv_quantize", "kv_dequantize",
           "Int8ServingLinear", "quantize_for_serving",
           "serving_state_bytes"]

# symmetric int8 grid: codes in [-127, 127]
KV_QMAX = 127.0


class QuantizedKV(NamedTuple):
    """Int8 KV storage: ``q`` int8 codes ``[..., head_dim]`` and
    ``scale`` fp32 ``[...]``, one absmax scale per token-and-head row.
    ``shape``, ``dtype`` and ``ndim`` are the codes', so shape probes
    that take a pool tensor take a QuantizedKV unchanged."""

    q: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self):
        return self.q.shape

    @property
    def dtype(self):
        return self.q.dtype

    @property
    def ndim(self):
        return self.q.ndim

    @property
    def nbytes(self):
        return self.q.nbytes + self.scale.nbytes


def kv_quantize(x: torch.Tensor) -> QuantizedKV:
    """Symmetric absmax int8 quantization over the last axis:
    ``scale = amax / 127`` per row, codes clipped to [-127, 127]. A zero
    row gets scale 0 and a guarded divide, so it dequantizes to zeros."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / KV_QMAX
    denom = torch.where(scale > 0, scale, torch.ones_like(scale))[..., None]
    q = torch.clamp(torch.round(xf / denom), -KV_QMAX, KV_QMAX)
    return QuantizedKV(q.to(torch.int8), scale)


def kv_dequantize(c: QuantizedKV, dtype=torch.float32) -> torch.Tensor:
    """``q * scale`` per row, fp32 unless asked otherwise."""
    return (c.q.float() * c.scale[..., None]).to(dtype)


class Int8ServingLinear(nn.Module):
    """Deploy form of ``Linear`` (counterpart: serving.py:96): int8 codes
    ``weight_q`` ``[in, out]`` and fp32 ``weight_scale`` (``[out]`` per
    channel, ``[in / group_size, out]`` per group) as buffers. The port's
    ``Linear`` has no bias, so neither has this.

    Per channel the scale factors out of the product: the codes are
    multiplied in ``x``'s dtype with fp32 sums, the ``[..., out]`` result
    is multiplied by ``max(scale, 1e-8) / 127`` in fp32 and rounded once
    to ``x``'s dtype. On the card a bf16 ``x`` takes one ``torch.mm`` with
    an fp32 output over a bf16 copy of the codes made for that call and
    dropped after it; on the CPU the product is fp32. Per group the
    weight is dequantized to ``x``'s dtype first and multiplied."""

    def __init__(self, weight_q: torch.Tensor, weight_scale: torch.Tensor):
        super().__init__()
        self.in_features = int(weight_q.shape[0])
        self.out_features = int(weight_q.shape[1])
        self.register_buffer("weight_q", weight_q.to(torch.int8))
        self.register_buffer("weight_scale", weight_scale.float())

    @classmethod
    def from_linear(cls, linear):
        """Per-channel codes and scales of a ``Linear``'s weight."""
        return cls(*quantize_weight(linear.weight))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.weight_scale.dim() == 2:          # groupwise
            w = _dequantize_weight(self.weight_q, self.weight_scale,
                                   dtype=x.dtype)
            return x @ w
        x2 = x.reshape(-1, self.in_features)
        if x.is_cuda and x.dtype != torch.float32:
            acc = torch.mm(x2, self.weight_q.to(x.dtype),
                           out_dtype=torch.float32)
        else:
            acc = x2.float() @ self.weight_q.float()
        s = torch.clamp(self.weight_scale, min=1e-8) / 127.0
        out = (acc * s).to(x.dtype)
        return out.reshape(*x.shape[:-1], self.out_features)


def quantize_for_serving(model: nn.Module, inplace: bool = False
                         ) -> nn.Module:
    """Swap every ``Linear`` in ``model`` but the ``lm_head`` for a
    per-channel :class:`Int8ServingLinear` (counterpart: serving.py:148,
    with its defaults; the JAX package's ``group_size`` and
    ``quantize_lm_head`` are not ported). Returns the model in eval mode:
    a deep copy, or ``model`` itself with ``inplace`` (which frees each
    fp weight as it goes, so a large model on the card never holds
    both)."""
    from ..nn.layer import Linear
    if not inplace:
        model = copy.deepcopy(model)

    def _convert(module: nn.Module) -> None:
        for name, sub in list(module.named_children()):
            if isinstance(sub, Linear):
                if name != "lm_head":
                    setattr(module, name, Int8ServingLinear.from_linear(sub))
            else:
                _convert(sub)

    with torch.no_grad():
        _convert(model)
    model.eval()
    return model


def serving_state_bytes(model: nn.Module) -> int:
    """Bytes of the model's whole serving state, parameters and buffers
    (the rope tables included, as the JAX package counts them): 1 byte
    per int8 weight element plus the fp32 scales after
    :func:`quantize_for_serving`."""
    return int(sum(t.nbytes for t in itertools.chain(model.parameters(),
                                                     model.buffers())))
