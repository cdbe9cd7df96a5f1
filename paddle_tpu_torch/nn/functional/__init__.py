"""Functional ops of the port (counterpart: paddle_tpu/nn/functional)."""

import torch

from ...ops.kernels.flash_attention import flash_attn_unpadded
from .attention import (cached_prefill_attention, paged_attention_decode,
                        scaled_dot_product_attention)
from .loss import cross_entropy
from .norm import layer_norm, rms_norm

__all__ = ["cached_prefill_attention", "paged_attention_decode",
           "scaled_dot_product_attention", "cross_entropy", "layer_norm",
           "rms_norm", "silu", "relu", "gelu", "tanh", "linear",
           "embedding", "dropout", "flash_attn_unpadded"]

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
    common.py:72, ``jnp.take``). Its backward sums each row's gradient in
    a fixed order on every device, so a seed reproduces a run bitwise: on
    the card indexing's (``index_put_`` with accumulation, sort-based
    there), on the CPU ``torch.nn.functional.embedding``'s (indexing
    accumulates in thread order on the CPU)."""
    if ids.is_cuda:
        return weight[ids.long()]
    return torch.nn.functional.embedding(ids.long(), weight)


def dropout(x: torch.Tensor, p: float = 0.5, axis=None,
            training: bool = True, mode: str = "upscale_in_train",
            generator: torch.Generator | None = None) -> torch.Tensor:
    """Counterpart of common.py:31-45. Not training, or ``p == 0``: x
    (``upscale_in_train``) or ``x * (1 - p)`` (``downscale_in_infer``).
    ``p == 1``: zeros. Otherwise a keep mask ``torch.rand(shape,
    generator=generator) < 1 - p`` (the counterpart of ``bernoulli(1 -
    p)``; ``shape`` is x's, with size 1 on every dimension outside
    ``axis`` when ``axis`` is given) and ``where(keep, x / (1 - p), 0)``
    (``upscale_in_train``) or ``where(keep, x, 0)``. The bits come from
    ``generator`` (the default generator of x's device when None), not
    ``jax.random``'s: a run reproduces from its generator's state, never
    the JAX package's mask (ROADMAP.md A1)."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout mode must be 'upscale_in_train' or "
                         f"'downscale_in_infer'; got {mode!r}")
    if not training or p == 0.0:
        return x if mode == "upscale_in_train" else x * (1.0 - p)
    if p == 1.0:
        return torch.zeros_like(x)
    shape = list(x.shape)
    if axis is not None:
        axes = [a % x.dim() for a in (axis if isinstance(axis, (list, tuple))
                                      else [axis])]
        shape = [n if i in axes else 1 for i, n in enumerate(shape)]
    keep = torch.rand(shape, generator=generator, device=x.device) < 1.0 - p
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), zero).to(x.dtype)
    return torch.where(keep, x, zero)
