"""Functional ops of the port (counterpart: paddle_tpu/nn/functional)."""

import torch

from .attention import (cached_prefill_attention, paged_attention_decode,
                        scaled_dot_product_attention)
from .loss import cross_entropy
from .norm import rms_norm

__all__ = ["cached_prefill_attention", "paged_attention_decode",
           "scaled_dot_product_attention", "cross_entropy", "rms_norm",
           "silu", "linear", "embedding"]


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) (counterpart: activation.py:74, jax.nn.silu)."""
    return torch.nn.functional.silu(x)


def linear(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """y = x @ W with the Paddle ``[in, out]`` weight (counterpart:
    common.py:21)."""
    return x @ weight


def embedding(ids: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Row gather from a ``[vocab, dim]`` table (counterpart:
    common.py:72)."""
    return weight[ids.long()]
