"""Llama decoder (counterpart: paddle_tpu/models/llama.py).

Same configuration fields, parameter names and Paddle weight layout as
the JAX model, so a JAX ``state_dict`` loads unchanged
(``models/weights.py``). Two attention branches are ported:

- the PAGED branch (llama.py:226-268), the serving engine's: the step's
  K/V rows are scattered into the layer's ``(pool_k, pool_v)`` first —
  inactive slots and padded rows write scratch page 0; an int8 pool
  (two ``QuantizedKV``) takes the rows' codes and scales — and then
  attended through ``paged_attention_decode``. The JAX model replaces
  the pool arrays functionally; the port writes them in place and
  returns the same tensors.
- the UNCACHED causal branch (llama.py:354-372), the training path:
  differentiable end to end; from 256 query rows on its attention is
  flash attention (the CUDA kernels on the card), below that the plain
  core. :meth:`LlamaForCausalLM.loss` is the shifted causal-LM cross
  entropy.

Not ported here: LoRA, tensor/pipeline/sequence parallelism, recompute,
and ``generate()`` over contiguous caches (ROADMAP.md). The config keeps
the JAX package's ``recompute``, ``mp_axis`` and ``fsdp_axis`` fields so
that its configurations construct unchanged; a value that would ask for
one of those features raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..core import resolve_device, resolve_dtype
from ..nn import functional as F
from ..nn.layer import Embedding, Linear, RMSNorm
from ..quantization.serving import QuantizedKV, kv_quantize

__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaModel",
           "LlamaDecoderLayer", "llama_tiny", "llama_3_8b",
           "apply_rotary_pos_emb"]


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    recompute: bool = False
    dtype: str = "float32"
    # the JAX package's parallel axes; the port runs on one device
    mp_axis: str | None = None
    fsdp_axis: str | None = None

    def __post_init__(self):
        if self.recompute:
            raise NotImplementedError(
                "recompute is not ported yet (ROADMAP.md A2)")
        if self.mp_axis is not None or self.fsdp_axis is not None:
            raise NotImplementedError(
                "tensor and FSDP parallelism are not ported: pass "
                "mp_axis=None and fsdp_axis=None")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def llama_tiny(**kw) -> LlamaConfig:
    """Test-scale config (counterpart: llama.py:737)."""
    return LlamaConfig(vocab_size=512, hidden_size=128, intermediate_size=384,
                       num_hidden_layers=2, num_attention_heads=4,
                       num_key_value_heads=2, max_position_embeddings=512,
                       **kw)


def llama_3_8b(**kw) -> LlamaConfig:
    """Llama-3-8B widths (counterpart: llama.py:750)."""
    return LlamaConfig(vocab_size=128256, hidden_size=4096,
                       intermediate_size=14336, num_hidden_layers=32,
                       num_attention_heads=32, num_key_value_heads=8,
                       max_position_embeddings=8192, rope_theta=500000.0,
                       **kw)


def _rope_cache(config: LlamaConfig, device) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """fp32 ``[max_pos, head_dim / 2]`` cos/sin tables (llama.py:69)."""
    dim = config.head_dim
    inv_freq = 1.0 / (config.rope_theta ** (
        torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))
    t = torch.arange(config.max_position_embeddings, dtype=torch.float32,
                     device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rotary_pos_emb(x, cos, sin, position_ids=None):
    """x ``[b, s, h, d]``; cos/sin ``[S, d/2]``; rotate in fp32 and cast
    back (llama.py:166)."""
    s = x.shape[1]
    if position_ids is None:
        c = cos[:s][None, :, None, :]
        si = sin[:s][None, :, None, :]
    else:
        c = cos[position_ids][:, :, None, :]
        si = sin[position_ids][:, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    xf1, xf2 = x1.float(), x2.float()
    out = torch.cat([xf1 * c - xf2 * si, xf2 * c + xf1 * si], dim=-1)
    return out.to(x.dtype)


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, device, dtype):
        super().__init__()
        self.config = config
        h, kvh, d = (config.num_attention_heads, config.num_key_value_heads,
                     config.head_dim)
        kw = dict(device=device, dtype=dtype)
        self.q_proj = Linear(config.hidden_size, h * d, **kw)
        self.k_proj = Linear(config.hidden_size, kvh * d, **kw)
        self.v_proj = Linear(config.hidden_size, kvh * d, **kw)
        self.o_proj = Linear(h * d, config.hidden_size, **kw)

    def forward(self, x, cos, sin, kv_cache=None, paged=None):
        b, s, _ = x.shape
        d = self.config.head_dim
        q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        h, kvh = q.shape[-1] // d, k.shape[-1] // d
        q = q.reshape(b, s, h, d)
        k = k.reshape(b, s, kvh, d)
        v = v.reshape(b, s, kvh, d)
        if paged is not None:
            # paged = (block_tables [b, M] i32, seq_lens [b] i32,
            # active [b] bool[, n_live [b] i32]); row j sits at pool
            # position seq_lens + j; rows j >= n_live and inactive slots
            # write the scratch page 0
            tables, seq_lens, active = paged[:3]
            n_live = paged[3] if len(paged) > 3 else None
            rows = torch.arange(s, device=x.device)
            pos = seq_lens.long()[:, None] + rows[None, :]          # [b, s]
            q = apply_rotary_pos_emb(q, cos, sin, pos)
            k = apply_rotary_pos_emb(k, cos, sin, pos)
            pk, pv = kv_cache
            ps = pk.shape[1]
            live = active[:, None] & (
                rows[None, :] < (n_live.long()[:, None]
                                 if n_live is not None else s))
            page = tables.long().gather(
                1, (pos // ps).clamp(max=tables.shape[1] - 1))
            page = torch.where(live, page, 0)
            off = torch.where(live, pos % ps, 0)
            if isinstance(pk, QuantizedKV):
                # int8 pool: quantize the step's rows as they are written
                # (llama.py:254-263), codes and scales at one (page, off)
                for pool, new in ((pk, k), (pv, v)):
                    c = kv_quantize(new)
                    pool.q[page, off] = c.q
                    pool.scale[page, off] = c.scale
            else:
                pk[page, off] = k.to(pk.dtype)
                pv[page, off] = v.to(pv.dtype)
            out = F.paged_attention_decode(q, pk, pv, tables, seq_lens)
            return self.o_proj(out.reshape(b, s, h * d)), (pk, pv)
        if kv_cache is not None:
            raise NotImplementedError(
                "contiguous KV caches (generate()) are not ported yet "
                "(ROADMAP.md: 'generate() over contiguous caches')")
        q = apply_rotary_pos_emb(q, cos, sin)
        k = apply_rotary_pos_emb(k, cos, sin)
        if kvh != h:  # GQA: repeat kv heads for the uncached path
            k = k.repeat_interleave(h // kvh, dim=2)
            v = v.repeat_interleave(h // kvh, dim=2)
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        return self.o_proj(out.reshape(b, s, h * d))


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.gate_proj = Linear(config.hidden_size, config.intermediate_size,
                                **kw)
        self.up_proj = Linear(config.hidden_size, config.intermediate_size,
                              **kw)
        self.down_proj = Linear(config.intermediate_size, config.hidden_size,
                                **kw)

    def forward(self, x):
        # SwiGLU (llama.py:387)
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.self_attn = LlamaAttention(config, device, dtype)
        self.mlp = LlamaMLP(config, device, dtype)
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       config.rms_norm_eps, **kw)
        self.post_attention_layernorm = RMSNorm(config.hidden_size,
                                                config.rms_norm_eps, **kw)

    def forward(self, x, cos, sin, kv_cache=None, paged=None):
        h = self.input_layernorm(x)
        new_cache = None
        if paged is not None:
            h, new_cache = self.self_attn(h, cos, sin, kv_cache, paged)
        else:
            h = self.self_attn(h, cos, sin, kv_cache)
        x = x + h
        x = x + self.mlp(self.post_attention_layernorm(x))
        return (x, new_cache) if paged is not None else x


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, device, dtype):
        super().__init__()
        self.config = config
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size,
                                      device=device, dtype=dtype)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config, device, dtype)
             for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps,
                            device=device, dtype=dtype)
        cos, sin = _rope_cache(config, device)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    def forward(self, input_ids, kv_caches=None, paged=None):
        x = self.embed_tokens(input_ids)
        cos, sin = self.rope_cos, self.rope_sin
        if paged is None:
            if kv_caches is not None:
                raise NotImplementedError(
                    "contiguous KV caches (generate()) are not ported yet "
                    "(ROADMAP.md: 'generate() over contiguous caches')")
            for layer in self.layers:
                x = layer(x, cos, sin)
            return self.norm(x)
        new_caches = []
        for layer, cache in zip(self.layers, kv_caches):
            x, c = layer(x, cos, sin, cache, paged)
            new_caches.append(c)
        return self.norm(x), new_caches


class LlamaForCausalLM(nn.Module):
    """``LlamaForCausalLM(config, device=None, seed=0)``: ``device=None``
    means the GPU (RuntimeError without one — pass ``device="cpu"`` for
    the CPU). Weights are drawn on the device from ``seed`` with the JAX
    package's initialisers (``models.weights.init_random``); pass
    ``seed=None`` to leave them uninitialised for a ``load_state_dict``
    from the JAX model."""

    def __init__(self, config: LlamaConfig, device=None, seed: int | None = 0):
        super().__init__()
        self.config = config
        device = resolve_device(device)
        dtype = resolve_dtype(config.dtype)
        self.model = LlamaModel(config, device, dtype)
        if not config.tie_word_embeddings:
            self.lm_head = Linear(config.hidden_size, config.vocab_size,
                                  device=device, dtype=dtype)
        if seed is not None:
            from .weights import init_random
            init_random(self, seed)

    @property
    def device(self) -> torch.device:
        return self.model.embed_tokens.weight.device

    def forward(self, input_ids, kv_caches=None, paged=None):
        """Uncached: ``forward(ids) -> logits``. Paged (the serving
        engine's step): ``forward(ids, pools, paged) -> (logits, pools)``
        with ``pools`` the per-layer ``(pool_k, pool_v)`` list, written in
        place."""
        out = self.model(input_ids, kv_caches, paged)
        hidden, new_caches = out if paged is not None else (out, None)
        if self.config.tie_word_embeddings:
            logits = hidden @ self.model.embed_tokens.weight.T
        else:
            logits = self.lm_head(hidden)
        return (logits, new_caches) if paged is not None else logits

    def loss(self, logits, labels, ignore_index=-100):
        """Shifted causal-LM cross entropy (counterpart: llama.py:723):
        position t predicts label t + 1."""
        shift_logits = logits[:, :-1]
        shift_labels = labels[:, 1:]
        return F.cross_entropy(
            shift_logits.reshape(-1, shift_logits.shape[-1]),
            shift_labels.reshape(-1), ignore_index=ignore_index)

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())
