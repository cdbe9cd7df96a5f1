"""GPT-2/3 style decoder (counterpart: paddle_tpu/models/gpt.py).

Same configuration fields, parameter names (``transformer.wte``,
``transformer.wpe``, ``transformer.blocks.N.{ln_1, attn_qkv, attn_out,
ln_2, mlp_fc, mlp_proj}``, ``transformer.ln_f``) and Paddle weight layout
(``[in, out]``) as the JAX model, so a JAX ``state_dict`` loads unchanged
(``models/weights.py``). Pre-norm blocks: LayerNorm takes the
hand-written kernel on the card, attention is causal
``scaled_dot_product_attention`` over the fused QKV projection's strided
views (flash attention from 256 query rows on, read through the views'
strides, its dropout in the kernels' dropout mode), exact-erf GELU, and
the LM head is ``h @ wte.weight.T``, the word embedding tied.

Dropout (``hidden_dropout_prob`` on the embeddings and on both residual
branches, ``attention_probs_dropout_prob`` on the probabilities) draws
from the model's ``generator``, seeded from ``seed``: one
``torch.Generator`` on the model's device, shared by every Dropout and
attention call (as ``Qwen2MoeForCausalLM``'s routers share theirs), so a
seed and the generator's state reproduce a run. The bits are not
``jax.random``'s (ROADMAP.md A1).

``mp_axis`` is kept so that the JAX package's configurations construct;
the port has no mesh, so a value other than None raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..core import resolve_device, resolve_dtype
from ..nn import functional as F
from ..nn.layer import Dropout, Embedding, LayerNorm, Linear, set_generator

__all__ = ["GPTConfig", "GPTBlock", "GPTModel", "GPTForCausalLM",
           "gpt2_small", "gpt2_medium"]


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 1024
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-5
    dtype: str = "float32"
    mp_axis: str | None = "mp"


class GPTBlock(nn.Module):
    """Pre-norm attention and MLP, each with residual dropout (counterpart:
    gpt.py:33-62)."""

    def __init__(self, c: GPTConfig, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        h = c.hidden_size
        self.ln_1 = LayerNorm(h, epsilon=c.layer_norm_eps, **kw)
        self.attn_qkv = Linear(h, 3 * h, **kw)
        self.attn_out = Linear(h, h, **kw)
        self.ln_2 = LayerNorm(h, epsilon=c.layer_norm_eps, **kw)
        self.mlp_fc = Linear(h, c.intermediate_size, **kw)
        self.mlp_proj = Linear(c.intermediate_size, h, **kw)
        self.dropout = Dropout(c.hidden_dropout_prob)
        self.nheads = c.num_attention_heads
        self.attn_dropout_p = c.attention_probs_dropout_prob
        self.generator = None

    def forward(self, x):
        b, s, hdim = x.shape
        qkv = self.attn_qkv(self.ln_1(x)).reshape(b, s, 3, self.nheads,
                                                  hdim // self.nheads)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        a = F.scaled_dot_product_attention(
            q, k, v, is_causal=True,
            dropout_p=self.attn_dropout_p if self.training else 0.0,
            training=self.training, generator=self.generator)
        x = x + self.dropout(self.attn_out(a.reshape(b, s, hdim)))
        return x + self.dropout(self.mlp_proj(F.gelu(self.mlp_fc(
            self.ln_2(x)))))


class GPTModel(nn.Module):
    """Token and position embeddings, dropout, the blocks and the final
    LayerNorm (counterpart: gpt.py:65-83)."""

    def __init__(self, c: GPTConfig, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.config = c
        self.wte = Embedding(c.vocab_size, c.hidden_size, **kw)
        self.wpe = Embedding(c.max_position_embeddings, c.hidden_size, **kw)
        self.drop = Dropout(c.hidden_dropout_prob)
        self.blocks = nn.ModuleList([GPTBlock(c, device, dtype)
                                     for _ in range(c.num_hidden_layers)])
        self.ln_f = LayerNorm(c.hidden_size, epsilon=c.layer_norm_eps, **kw)

    def forward(self, input_ids):
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)[None, :]
        x = self.drop(self.wte(input_ids) + self.wpe(pos))
        for blk in self.blocks:
            x = blk(x)
        return self.ln_f(x)


class GPTForCausalLM(nn.Module):
    """``GPTForCausalLM(config, device=None, seed=0)``: logits through the
    tied word embedding (counterpart: gpt.py:86-99). ``device=None`` means
    the GPU (RuntimeError without one; pass ``device="cpu"`` for the
    CPU). Weights are drawn on the device from ``seed``
    (``models.weights.init_random``); ``seed=None`` leaves them for a
    ``load_numpy_state``. ``generator`` (seeded from ``seed``, or 0)
    draws every dropout mask and attention-dropout key."""

    def __init__(self, config: GPTConfig, device=None, seed: int | None = 0):
        super().__init__()
        if config.mp_axis is not None:
            raise NotImplementedError(
                "GPTConfig.mp_axis: the port has no mesh (tensor "
                "parallelism is not ported); pass mp_axis=None")
        device = resolve_device(device)
        self.transformer = GPTModel(config, device,
                                    resolve_dtype(config.dtype))
        self.config = config
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(0 if seed is None else int(seed))
        set_generator(self, self.generator)
        if seed is not None:
            from .weights import init_random
            init_random(self, seed)

    @property
    def device(self) -> torch.device:
        return self.transformer.wte.weight.device

    def forward(self, input_ids):
        h = self.transformer(input_ids)
        return h @ self.transformer.wte.weight.T   # tied lm head

    def loss(self, logits, labels):
        """Shifted causal-LM cross entropy (counterpart: gpt.py:97-99)."""
        return F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                               labels[:, 1:].reshape(-1))

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())


def gpt2_small(**kw) -> GPTConfig:
    """GPT-2 small (counterpart: gpt.py:102): the config's defaults."""
    return GPTConfig(**kw)


def gpt2_medium(**kw) -> GPTConfig:
    """GPT-2 medium widths (counterpart: gpt.py:106)."""
    return GPTConfig(hidden_size=1024, num_hidden_layers=24,
                     num_attention_heads=16, intermediate_size=4096, **kw)
