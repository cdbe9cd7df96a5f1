"""Functional ops of the port (counterpart: paddle_tpu/nn/functional)."""

import torch

from .attention import (cached_prefill_attention, paged_attention_decode,
                        scaled_dot_product_attention)
from .loss import cross_entropy
from .norm import layer_norm, rms_norm

__all__ = ["cached_prefill_attention", "paged_attention_decode",
           "scaled_dot_product_attention", "cross_entropy", "layer_norm",
           "rms_norm", "silu", "relu", "gelu", "tanh", "linear",
           "embedding", "dropout"]

_NO_DROPOUT = ("dropout with p > 0 in training is not ported yet: the JAX "
               "package draws its keep mask from jax.random, whose bits "
               "are not ported (ROADMAP.md A1)")


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) (counterpart: activation.py:74, jax.nn.silu)."""
    return torch.nn.functional.silu(x)


def relu(x: torch.Tensor) -> torch.Tensor:
    """Counterpart: activation.py:21 (``jax.nn.relu``)."""
    return torch.relu(x)


def gelu(x: torch.Tensor, approximate: bool = False) -> torch.Tensor:
    """GELU (counterpart: activation.py:70, ``jax.nn.gelu``): the exact
    erf form unless ``approximate`` (the tanh form)."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def tanh(x: torch.Tensor) -> torch.Tensor:
    """Counterpart: activation.py:137."""
    return torch.tanh(x)


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None = None) -> torch.Tensor:
    """y = x @ W (+ b) with the Paddle ``[in, out]`` weight (counterpart:
    common.py:21): the product and the bias add each round to the
    operands' dtype, as there."""
    y = x @ weight
    return y if bias is None else y + bias


def embedding(ids: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Row gather from a ``[vocab, dim]`` table (counterpart:
    common.py:72)."""
    return weight[ids.long()]


def dropout(x: torch.Tensor, p: float = 0.5,
            training: bool = True) -> torch.Tensor:
    """The identity when ``p == 0`` or not training (counterpart:
    common.py:31); raises otherwise."""
    if not training or p == 0.0:
        return x
    raise NotImplementedError(_NO_DROPOUT)
