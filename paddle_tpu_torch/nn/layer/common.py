"""Linear, Embedding and Dropout (counterpart:
paddle_tpu/nn/layer/common.py)."""

from __future__ import annotations

import math

import torch
from torch import nn

from .. import functional as F

__all__ = ["Linear", "Embedding", "Dropout", "set_generator"]


class Linear(nn.Module):
    """y = x @ W + b; ``weight`` is ``[in_features, out_features]``, the
    Paddle layout (counterpart: common.py:25-45). ``bias_attr=None``
    gives a ``[out_features]`` bias, initialised to zeros; ``False`` gives
    none (the Llama and Qwen2-MoE models pass it, as the JAX models do).
    Initialised by :meth:`reset_parameters` with the JAX package's
    XavierNormal. Initialiser objects (a callable ``bias_attr``) are not
    ported and raise."""

    def __init__(self, in_features: int, out_features: int, *,
                 bias_attr=None, device=None, dtype=None):
        super().__init__()
        if bias_attr not in (None, False):
            raise NotImplementedError("Linear takes bias_attr None or "
                                      "False only")
        self.in_features = in_features
        self.out_features = out_features
        self.weight = nn.Parameter(torch.empty(
            (in_features, out_features), device=device, dtype=dtype))
        self.bias = (None if bias_attr is False else nn.Parameter(
            torch.empty((out_features,), device=device, dtype=dtype)))

    def reset_parameters(self, generator: torch.Generator) -> None:
        std = math.sqrt(2.0 / (self.in_features + self.out_features))
        with torch.no_grad():
            self.weight.normal_(0.0, std, generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class Embedding(nn.Module):
    """Token embedding, ``weight`` ``[num_embeddings, embedding_dim]``
    (counterpart: common.py:54), initialised N(0, 1) as there."""

    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 device=None, dtype=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = nn.Parameter(torch.empty(
            (num_embeddings, embedding_dim), device=device, dtype=dtype))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0, generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight)


class Dropout(nn.Module):
    """Counterpart of common.py:85-94: ``F.dropout`` with ``p``, ``axis``
    and ``mode`` in training, the identity (``upscale_in_train``) in eval
    mode. ``generator`` draws the keep masks (None: the default generator
    of the input's device); a model that owns a generator sets it on
    every Dropout, so that one seed reproduces a run."""

    def __init__(self, p: float = 0.5, axis=None,
                 mode: str = "upscale_in_train",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode
        self.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.dropout(x, p=self.p, axis=self.axis, training=self.training,
                         mode=self.mode, generator=self.generator)


def set_generator(model: nn.Module, generator: torch.Generator) -> None:
    """Give every module of ``model`` that draws random numbers (each one
    with a ``generator`` attribute: ``Dropout``, ``MultiHeadAttention``, a
    GPT block) the one generator of the model, so that its seed
    reproduces a run."""
    for module in model.modules():
        if hasattr(module, "generator"):
            module.generator = generator
