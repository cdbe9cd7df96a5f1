"""Transformer encoder layers (counterpart:
paddle_tpu/nn/layer/transformer.py).

``MultiHeadAttention`` keeps Paddle's ``[batch, seq, hidden]`` API and
its score computation goes through
``nn.functional.scaled_dot_product_attention``, which takes flash
attention (the CUDA kernels on the card) from 256 query rows on, a mask
included. Parameter names are the JAX package's
(``self_attn.{q,k,v,out}_proj``, ``linear1``, ``linear2``, ``norm1``,
``norm2``, ``layers.N``), so a JAX ``state_dict`` loads unchanged.
Dropout, on the probabilities and on the residual branches, draws from
the ``generator`` attribute of each ``MultiHeadAttention`` and
``Dropout`` (None: the device's default generator); a model that owns a
generator sets it on each (``common.set_generator``).

Not ported yet: the KV-cache protocol (``gen_cache``, ``Cache``,
``StaticCache``, the ``cache`` arguments) and the decoder classes
(``TransformerDecoderLayer``, ``TransformerDecoder``, ``Transformer``);
the cache entry points raise.
"""

from __future__ import annotations

import copy

from torch import nn

from .. import functional as F
from .common import Dropout, Linear
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder"]

_NO_CACHE = ("the transformer KV-cache protocol (gen_cache, Cache, "
             "StaticCache) is not ported yet")


class MultiHeadAttention(nn.Module):
    """Counterpart of transformer.py:24-96, without the caches and the
    separate key/value widths (``kdim``, ``vdim``); ``generator`` draws
    the attention dropout's key."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 *, device=None, dtype=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.generator = None
        kw = dict(device=device, dtype=dtype)
        self.q_proj = Linear(embed_dim, embed_dim, **kw)
        self.k_proj = Linear(embed_dim, embed_dim, **kw)
        self.v_proj = Linear(embed_dim, embed_dim, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, **kw)

    def _split(self, x):
        b, s, _ = x.shape
        return x.reshape(b, s, self.num_heads, self.head_dim)

    def gen_cache(self, key, value=None, type=None):
        raise NotImplementedError(_NO_CACHE)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        if cache is not None:
            raise NotImplementedError(_NO_CACHE)
        key = query if key is None else key
        value = key if value is None else value
        q = self._split(self.q_proj(query))
        k = self._split(self.k_proj(key))
        v = self._split(self.v_proj(value))
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask,
            dropout_p=self.dropout if self.training else 0.0,
            training=self.training, generator=self.generator)
        b, s = out.shape[0], out.shape[1]
        return self.out_proj(out.reshape(b, s, self.embed_dim))


class TransformerEncoderLayer(nn.Module):
    """Counterpart of transformer.py:99-146: post-norm by default,
    pre-norm with ``normalize_before``."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = 0.1, activation: str = "relu",
                 attn_dropout=None, act_dropout=None,
                 normalize_before: bool = False,
                 layer_norm_eps: float = 1e-5, *, device=None, dtype=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        kw = dict(device=device, dtype=dtype)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **kw)
        self.linear2 = Linear(dim_feedforward, d_model, **kw)
        self.norm1 = LayerNorm(d_model, epsilon=layer_norm_eps, **kw)
        self.norm2 = LayerNorm(d_model, epsilon=layer_norm_eps, **kw)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.act_dropout = Dropout(act_dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        if cache is not None:
            raise NotImplementedError(_NO_CACHE)
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        src = residual + self.dropout1(self.self_attn(src, src, src,
                                                      src_mask))
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.act_dropout(self.activation(
            self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src

    def gen_cache(self, src):
        raise NotImplementedError(_NO_CACHE)


class TransformerEncoder(nn.Module):
    """Counterpart of transformer.py:149-175: ``num_layers`` copies of
    ``encoder_layer`` (``layers.N``), then ``norm`` when given."""

    def __init__(self, encoder_layer: TransformerEncoderLayer,
                 num_layers: int, norm=None):
        super().__init__()
        self.layers = nn.ModuleList(
            [encoder_layer] + [copy.deepcopy(encoder_layer)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        if cache is not None:
            raise NotImplementedError(_NO_CACHE)
        output = src
        for layer in self.layers:
            output = layer(output, src_mask)
        if self.norm is not None:
            output = self.norm(output)
        return output

    def gen_cache(self, src):
        raise NotImplementedError(_NO_CACHE)
