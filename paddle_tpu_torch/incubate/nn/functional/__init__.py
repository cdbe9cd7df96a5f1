"""Counterpart: paddle_tpu/incubate/nn/functional; of its functions the
port holds ``variable_length_memory_efficient_attention`` alone."""

from ....ops.kernels.flash_attention import flash_attn_unpadded

__all__ = ["variable_length_memory_efficient_attention"]


def variable_length_memory_efficient_attention(q, k, v, cu_seqlens_q,
                                               cu_seqlens_k,
                                               causal: bool = False,
                                               scale: float | None = None):
    """Attention over packed sequences (counterpart:
    paddle_tpu/incubate/nn/functional/__init__.py:237): the segment mode
    of the flash kernels, through :func:`flash_attn_unpadded`."""
    return flash_attn_unpadded(q, k, v, cu_seqlens_q, cu_seqlens_k,
                               causal=causal, scale=scale)
