"""Weight-only int8 quantization (counterpart:
paddle_tpu/quantization/__init__.py:88-163) and the serving-time int8
subsystem (:mod:`.serving`, re-exported here).

Symmetric absmax quantization of ``[in, out]`` linear weights, per
output channel (scales ``[out]``) or per group of ``group_size`` input
rows (scales ``[in / group_size, out]``). The arithmetic keeps the JAX
package's order of operations, ``round(w / max(s, 1e-8) * qmax)``
clipped to ``[-qmax - 1, qmax]``, so the codes equal the JAX package's
bitwise (``torch.round`` rounds half to even, as ``jnp.round`` does).

Not ported here: QAT, PTQ, the observers other than the groupwise one,
fake quantization and the ``Quanted*``/``Quantized*`` layers.
"""

from __future__ import annotations

import torch

__all__ = ["GroupWiseWeightObserver", "quantize_weight",
           "QuantizedKV", "KV_QMAX", "kv_quantize", "kv_dequantize",
           "Int8ServingLinear", "quantize_for_serving",
           "serving_state_bytes"]


class GroupWiseWeightObserver:
    """Per-group absmax scales for weight-only int quantization
    (counterpart: quantization/__init__.py:88): the reduction axis of
    an ``[in, out]`` weight splits into groups of ``group_size`` rows."""

    def __init__(self, quant_bits: int = 8, group_size: int = 128):
        self.bits = quant_bits
        self.group_size = group_size

    def scales(self, w: torch.Tensor) -> torch.Tensor:
        """``[in, out]`` -> fp32 ``[in / group_size, out]``."""
        gin, out = w.shape[0] // self.group_size, w.shape[1]
        g = w.float().abs().reshape(gin, self.group_size, out)
        return g.amax(dim=1)


def _check_int8_bits(bits: int) -> float:
    if bits > 8:
        raise ValueError(f"int8 deploy storage holds at most 8 bits, got "
                         f"bit_length={bits}; convert() cannot emit this "
                         f"quanter's grid losslessly")
    return 2.0 ** (bits - 1) - 1


def _quantize(wf: torch.Tensor, scales_full: torch.Tensor,
              bits: int) -> torch.Tensor:
    """Shared symmetric quantize: ``wf`` fp32, ``scales_full``
    broadcastable to it."""
    qmax = _check_int8_bits(bits)
    s = torch.clamp(scales_full, min=1e-8)
    return torch.clamp(torch.round(wf / s * qmax), -qmax - 1,
                       qmax).to(torch.int8)


def quantize_weight(w: torch.Tensor, bits: int = 8,
                    group_size: int | None = None):
    """Symmetric weight-only int8 quantization of an ``[in, out]``
    weight (counterpart: quantization/__init__.py:124). Returns
    ``(codes int8 [in, out], scales fp32)``: ``[out]`` per channel, or
    ``[in / group_size, out]`` per group. Dequantize as
    ``codes * expand(scales) / qmax``."""
    wf = w.detach().float()
    if group_size:
        if wf.shape[0] % group_size:
            raise ValueError(
                f"group_size={group_size} does not divide in_features="
                f"{wf.shape[0]}; a silent per-channel fallback would emit "
                f"a different scale layout than the caller asked for")
        scales = GroupWiseWeightObserver(bits, group_size).scales(wf)
        s_full = scales.repeat_interleave(group_size, dim=0)
    else:
        scales = wf.abs().amax(dim=0)                       # [out]
        s_full = scales[None, :]
    return _quantize(wf, s_full, bits), scales


def _dequantize_weight(q: torch.Tensor, scales: torch.Tensor, bits: int = 8,
                       dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_weight`; the group size of 2-D scales
    is ``q.shape[0] // scales.shape[0]``."""
    if scales.dim() == 2:
        gs = q.shape[0] // scales.shape[0]
        s_full = scales.repeat_interleave(gs, dim=0)
    else:
        s_full = scales[None, :]
    return _dequantize(q, s_full, bits, dtype)


def _dequantize(q: torch.Tensor, scales_full: torch.Tensor, bits: int,
                dtype) -> torch.Tensor:
    """Shared symmetric dequantize, clamped as in :func:`_quantize` so a
    zero-scale channel stays zero."""
    qmax = _check_int8_bits(bits)
    s = torch.clamp(scales_full, min=1e-8)
    return (q.float() * (s / qmax)).to(dtype)


from .serving import (KV_QMAX, Int8ServingLinear, QuantizedKV,  # noqa: E402
                      kv_dequantize, kv_quantize, quantize_for_serving,
                      serving_state_bytes)
