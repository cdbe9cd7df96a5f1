"""Qwen2-MoE decoder (counterpart: paddle_tpu/models/qwen2_moe.py).

GQA attention (the port's ``LlamaAttention``, flash attention from 256
query rows on) and, in every ``decoder_sparse_step``-th layer, a sparse
MLP: top-2 routed experts (``distributed.moe.MoELayer``) plus an
always-on shared expert scaled by a learned sigmoid gate. The routers'
load-balance losses join the LM loss. Same configuration fields,
parameter names and weight layouts as the JAX model, so a JAX
``state_dict`` loads unchanged (``models/weights.py``); each router
weight stays fp32 in a bf16 model, as there.

The random keep of each token's second expert draws from the model's
``generator`` (a ``torch.Generator`` seeded from ``seed``; reseed it to
repeat a run). Not ported: recompute, the parallel axes and the
``"einsum"``, ``"ragged"`` and ``"alltoall"`` dispatch modes (ROADMAP.md
A10); they raise.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..core import resolve_device, resolve_dtype
from ..distributed.moe import ExpertFFN, MoELayer, TopKGate
from ..nn import functional as F
from ..nn.layer import Embedding, Linear, RMSNorm
from .llama import LlamaAttention, LlamaConfig, LlamaMLP, _rope_cache

__all__ = ["Qwen2MoeConfig", "Qwen2MoeForCausalLM", "Qwen2MoeDecoderLayer",
           "Qwen2MoeSparseMLP", "qwen2_moe_tiny"]


@dataclass
class Qwen2MoeConfig:
    vocab_size: int = 151936
    hidden_size: int = 2048
    intermediate_size: int = 5632
    moe_intermediate_size: int = 1408
    shared_expert_intermediate_size: int = 5632
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    num_experts: int = 60
    num_experts_per_tok: int = 4
    decoder_sparse_step: int = 1
    max_position_embeddings: int = 8192
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1e6
    router_aux_loss_coef: float = 0.001
    recompute: bool = False
    dtype: str = "float32"
    # the JAX package's parallel axes; the port runs on one device
    mp_axis: str | None = None
    fsdp_axis: str | None = None
    ep_axis: str | None = None
    ep_dispatch: str = "grouped"
    sep_axis: str | None = None

    def __post_init__(self):
        if any(a is not None for a in (self.ep_axis, self.sep_axis)):
            raise NotImplementedError(
                "expert and sequence parallelism are not ported (ROADMAP.md "
                "A10): pass ep_axis=None and sep_axis=None")
        self._attn_cfg()      # raises on recompute and the other axes

    def _attn_cfg(self) -> LlamaConfig:
        return LlamaConfig(
            vocab_size=self.vocab_size, hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size,
            num_hidden_layers=self.num_hidden_layers,
            num_attention_heads=self.num_attention_heads,
            num_key_value_heads=self.num_key_value_heads,
            max_position_embeddings=self.max_position_embeddings,
            rms_norm_eps=self.rms_norm_eps, rope_theta=self.rope_theta,
            recompute=self.recompute, dtype=self.dtype,
            mp_axis=self.mp_axis, fsdp_axis=self.fsdp_axis)


def qwen2_moe_tiny(**kw) -> Qwen2MoeConfig:
    """Test-scale config (counterpart: qwen2_moe.py:178)."""
    return Qwen2MoeConfig(vocab_size=256, hidden_size=64,
                          intermediate_size=192, moe_intermediate_size=48,
                          shared_expert_intermediate_size=96,
                          num_hidden_layers=2, num_attention_heads=4,
                          num_key_value_heads=2, num_experts=4,
                          num_experts_per_tok=2,
                          max_position_embeddings=128, **kw)


class Qwen2MoeSparseMLP(nn.Module):
    """Routed top-k experts plus a shared expert with a sigmoid gate."""

    def __init__(self, config: Qwen2MoeConfig, device, dtype):
        super().__init__()
        gate = TopKGate(config.hidden_size, config.num_experts,
                        top_k=config.num_experts_per_tok, device=device)
        experts = ExpertFFN(config.num_experts, config.hidden_size,
                            config.moe_intermediate_size, device=device,
                            dtype=dtype)
        self.moe = MoELayer(config.hidden_size, experts=experts, gate=gate,
                            dispatch=config.ep_dispatch, device=device,
                            dtype=dtype)
        shared_cfg = config._attn_cfg()
        shared_cfg.intermediate_size = config.shared_expert_intermediate_size
        self.shared_expert = LlamaMLP(shared_cfg, device, dtype)
        self.shared_expert_gate = Linear(config.hidden_size, 1,
                                         bias_attr=False, device=device,
                                         dtype=dtype)

    @property
    def aux_loss(self):
        return self.moe.aux_loss

    def forward(self, x):
        routed = self.moe(x)
        shared = self.shared_expert(x) * torch.sigmoid(
            self.shared_expert_gate(x))
        return routed + shared


class Qwen2MoeDecoderLayer(nn.Module):
    def __init__(self, config: Qwen2MoeConfig, layer_idx: int, device,
                 dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.self_attn = LlamaAttention(config._attn_cfg(), device, dtype)
        self.is_sparse = (config.num_experts > 0 and
                          (layer_idx + 1) % config.decoder_sparse_step == 0)
        self.mlp = (Qwen2MoeSparseMLP(config, device, dtype)
                    if self.is_sparse
                    else LlamaMLP(config._attn_cfg(), device, dtype))
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       config.rms_norm_eps, **kw)
        self.post_attention_layernorm = RMSNorm(config.hidden_size,
                                                config.rms_norm_eps, **kw)

    def forward(self, x, cos, sin):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin)
        return x + self.mlp(self.post_attention_layernorm(x))


class Qwen2MoeForCausalLM(nn.Module):
    """``Qwen2MoeForCausalLM(config, device=None, seed=0)``: ``device=None``
    means the GPU (RuntimeError without one). Weights are drawn on the
    device from ``seed`` (``models.weights.init_random``); ``seed=None``
    leaves them for a ``load_numpy_state``. ``generator`` (seeded from
    ``seed``, or 0) draws every router's random keep."""

    def __init__(self, config: Qwen2MoeConfig, device=None,
                 seed: int | None = 0):
        super().__init__()
        self.config = config
        device = resolve_device(device)
        dtype = resolve_dtype(config.dtype)
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size,
                                      device=device, dtype=dtype)
        self.layers = nn.ModuleList(
            [Qwen2MoeDecoderLayer(config, i, device, dtype)
             for i in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps,
                            device=device, dtype=dtype)
        self.lm_head = Linear(config.hidden_size, config.vocab_size,
                              bias_attr=False, device=device, dtype=dtype)
        cos, sin = _rope_cache(config._attn_cfg(), device)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(0 if seed is None else int(seed))
        for layer in self.layers:
            if layer.is_sparse:
                layer.mlp.moe.gate.generator = self.generator
        if seed is not None:
            from .weights import init_random
            init_random(self, seed)

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.weight.device

    def forward(self, input_ids):
        x = self.embed_tokens(input_ids)
        for layer in self.layers:
            x = layer(x, self.rope_cos, self.rope_sin)
        return self.lm_head(self.norm(x))

    def aux_loss(self):
        """Sum of the routers' load-balance losses of the last forward."""
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for layer in self.layers:
            if layer.is_sparse:
                total = total + layer.mlp.aux_loss
        return total

    def loss(self, logits, labels, ignore_index=-100):
        """Shifted causal-LM cross entropy plus ``router_aux_loss_coef``
        times :meth:`aux_loss` (counterpart: qwen2_moe.py:164)."""
        shift_logits = logits[:, :-1]
        shift_labels = labels[:, 1:]
        ce = F.cross_entropy(
            shift_logits.reshape(-1, shift_logits.shape[-1]),
            shift_labels.reshape(-1), ignore_index=ignore_index)
        return ce + self.config.router_aux_loss_coef * self.aux_loss()

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())
