"""Mixture-of-Experts on one device (counterpart:
paddle_tpu/distributed/moe.py).

Ported: GShard top-2 routing (``_top2_parts``, its ``impl="fused"``
switch to the routing kernel, ``_top2_epilogue``), ``TopKGate``'s sparse
routing, ``ExpertFFN``, the capacity-packed grouped dispatch
(``moe_grouped_compute``) and the fused grouped-GEMM dispatch
(``moe_fused_compute``, the CUDA kernels on the card), and ``MoELayer``
with ``dispatch="grouped"`` or ``"fused"``. The fused dispatch runs only
where the JAX package's gates (``fused_dispatch_applicable``,
``fused_routing_applicable``) hold, so both packages compute the same
function on the same shapes; elsewhere the grouped path and the plain
routing chain run, as there.

Not ported (ROADMAP.md A10): top-1 routing (``_top1_parts``,
``SwitchGate``'s routing), the dense one-hot dispatch (``"einsum"``,
``TopKGate.forward``), ``"ragged"`` and the expert-parallel all-to-all
(``"alltoall"``, ``global_scatter``/``global_gather``). They raise.

Randomness: the second expert's random keep draws ``T`` uniforms in
training, as the JAX package does with ``jax.random.uniform`` on its
next key. The port draws them with ``torch.rand`` from the gate's
``torch.Generator`` (the model's, seeded from its ``seed``), through
:func:`draw_uniform`, which tests replace to feed both packages the
same numbers.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..nn import functional as F
from ..ops.kernels.moe_grouped_gemm import (act_name_of,
                                            fused_dispatch_applicable,
                                            fused_grouped_moe,
                                            padded_capacity, slot_maps)
from ..ops.kernels.moe_routing import (fused_routing_applicable,
                                       fused_top2_routing, top2_epilogue)

__all__ = ["MoELayer", "TopKGate", "GShardGate", "SwitchGate", "ExpertFFN",
           "moe_grouped_compute", "moe_fused_compute", "draw_uniform"]

_UNPORTED = "is not ported yet (ROADMAP.md A10)"


def draw_uniform(n: int, generator: torch.Generator,
                 device) -> torch.Tensor:
    """``n`` fp32 uniforms in [0, 1) for the random second-expert keep."""
    return torch.rand((n,), generator=generator, dtype=torch.float32,
                      device=device)


def _top2_parts(logits, capacity, *, second_policy="random", u=None,
                balance_loss_weight=1.0, impl="xla"):
    """GShard top-2 gating core (counterpart: moe.py:127): ``(g1_idx,
    g2_idx, w1, w2, keep1, keep2f, p1, p2, aux)`` with ``w1``/``w2``
    zeroed for capacity-dropped copies and renormalised over the kept
    experts. ``u`` holds the ``T`` uniforms of the random keep (required
    when ``second_policy == "random"``). ``impl="fused"`` takes the
    routing kernel where ``fused_routing_applicable`` holds, else this
    plain chain."""
    T, E = logits.shape
    random = second_policy == "random"
    if random and u is None:
        raise ValueError("second_policy='random' needs the uniforms u")
    if impl == "fused" and fused_routing_applicable(T, E):
        return fused_top2_routing(logits, u if random else None,
                                  int(capacity), random,
                                  float(balance_loss_weight))
    probs = torch.softmax(logits.float(), dim=-1)
    g1_idx = probs.argmax(dim=-1)
    g1 = probs.gather(1, g1_idx[:, None])[:, 0]
    oh1 = torch.nn.functional.one_hot(g1_idx, E)
    probs_wo1 = probs * (1 - oh1)
    g2_idx = probs_wo1.argmax(dim=-1)
    g2 = probs_wo1.gather(1, g2_idx[:, None])[:, 0]
    me = probs.mean(dim=0)
    ce = oh1.float().mean(dim=0)
    aux = (me * ce).sum() * E * balance_loss_weight
    if random:
        keep2 = u < 2.0 * g2 / torch.clamp(g1 + g2, min=1e-9)
    else:
        keep2 = torch.ones((T,), dtype=torch.bool, device=logits.device)
    mask1 = oh1
    pos1 = torch.cumsum(mask1, dim=0) * mask1 - mask1      # 0-based
    count1 = mask1.sum(dim=0)
    mask2 = torch.nn.functional.one_hot(g2_idx, E) * keep2[:, None].long()
    pos2 = (torch.cumsum(mask2, dim=0) * mask2 - mask2) + count1[None, :]
    p1 = (pos1 * mask1).sum(dim=1)
    p2 = (pos2 * mask2).sum(dim=1)
    keep1 = p1 < capacity
    keep2f = (p2 < capacity) & (mask2.sum(dim=1) > 0)
    w1, w2 = top2_epilogue(g1, g2, keep1, keep2f)
    return g1_idx, g2_idx, w1, w2, keep1, keep2f, p1, p2, aux


def _xavier_uniform_(t: torch.Tensor, generator) -> None:
    """``I.XavierUniform()`` on a 2-D ``[in, out]`` weight."""
    limit = math.sqrt(6.0 / (t.shape[0] + t.shape[1]))
    with torch.no_grad():
        t.uniform_(-limit, limit, generator=generator)


class TopKGate(nn.Module):
    """Router: an fp32 linear gate and top-k routing (counterpart:
    moe.py:243). ``weight`` ``[d_model, num_experts]`` is fp32 whatever
    the model's dtype, as there. ``generator`` draws the random keep;
    a model sets its own on every gate."""

    def __init__(self, d_model, num_experts, top_k=2, capacity_factor=1.25,
                 eval_capacity_factor=2.0, balance_loss_weight=1.0,
                 jitter_eps=0.0, *, device=None, generator=None):
        super().__init__()
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.eval_capacity_factor = eval_capacity_factor
        self.balance_loss_weight = balance_loss_weight
        self.jitter_eps = jitter_eps
        self.weight = nn.Parameter(torch.empty(
            (d_model, num_experts), dtype=torch.float32, device=device))
        self.generator = generator

    def reset_parameters(self, generator: torch.Generator) -> None:
        _xavier_uniform_(self.weight, generator)

    def capacity(self, num_tokens):
        f = self.capacity_factor if self.training else \
            self.eval_capacity_factor
        return max(int(f * num_tokens * self.top_k / self.num_experts), 4)

    def logits(self, x):
        """fp32 router logits (an fp32 product whatever x's dtype)."""
        return x.float() @ self.weight

    def forward(self, x):
        raise NotImplementedError(f"the dense one-hot gating {_UNPORTED}; "
                                  f"use forward_sparse")

    def forward_sparse(self, x, impl="xla"):
        """``(idx, w, pos, keep, aux, capacity)``, each ``[T, 2]`` but aux
        and capacity (counterpart: moe.py:273)."""
        cap = self.capacity(x.shape[0])
        return (*self._route_sparse(self.logits(x), cap, impl=impl), cap)

    def _route_sparse(self, logits, cap, impl="xla"):
        """As moe.py:293: every ``top_k != 1`` routes top-2 (the
        capacity still counts ``top_k`` copies a token)."""
        if self.top_k == 1:
            raise NotImplementedError(f"top-1 routing (_top1_parts) "
                                      f"{_UNPORTED}")
        policy = "random" if self.training else "all"
        u = None
        if policy == "random":
            if self.generator is None:
                self.generator = torch.Generator(device=logits.device)
                self.generator.manual_seed(0)
            u = draw_uniform(logits.shape[0], self.generator, logits.device)
        g1_idx, g2_idx, w1, w2, keep1, keep2f, p1, p2, aux = _top2_parts(
            logits, cap, balance_loss_weight=self.balance_loss_weight,
            second_policy=policy, u=u, impl=impl)
        return (torch.stack([g1_idx, g2_idx], dim=1),
                torch.stack([w1, w2], dim=1),
                torch.stack([p1, p2], dim=1),
                torch.stack([keep1, keep2f], dim=1), aux)


class SwitchGate(TopKGate):
    """Top-1 gate (moe.py:315); its routing raises until ported."""

    def __init__(self, d_model, num_experts, capacity_factor=1.25, **kw):
        super().__init__(d_model, num_experts, top_k=1,
                         capacity_factor=capacity_factor, jitter_eps=0.01,
                         **kw)


class GShardGate(TopKGate):
    def __init__(self, d_model, num_experts, capacity_factor=1.25, **kw):
        super().__init__(d_model, num_experts, top_k=2,
                         capacity_factor=capacity_factor, **kw)


class ExpertFFN(nn.Module):
    """Batched expert FFNs (counterpart: moe.py:327): ``w_in``,
    ``w_gate`` ``[E, d_model, d_hidden]`` and ``w_out``
    ``[E, d_hidden, d_model]``, initialised with the JAX package's
    XavierNormal fans for a 3-D weight (``fan_in = shape[1] * shape[2]``,
    ``fan_out = shape[0] * shape[2]``)."""

    def __init__(self, num_experts, d_model, d_hidden, activation=F.silu,
                 ep_axis=None, gated=True, *, device=None, dtype=None):
        super().__init__()
        if ep_axis is not None:
            raise NotImplementedError(f"expert sharding (ep_axis) "
                                      f"{_UNPORTED}")
        self.activation = activation
        self.gated = gated
        kw = dict(device=device, dtype=dtype)
        self.w_in = nn.Parameter(torch.empty(
            (num_experts, d_model, d_hidden), **kw))
        self.w_gate = nn.Parameter(torch.empty(
            (num_experts, d_model, d_hidden), **kw)) if gated else None
        self.w_out = nn.Parameter(torch.empty(
            (num_experts, d_hidden, d_model), **kw))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for w in (self.w_in, self.w_gate, self.w_out):
                if w is None:
                    continue
                e, a, b = w.shape
                std = math.sqrt(2.0 / (a * b + e * b))
                w.normal_(0.0, std, generator=generator)

    def forward(self, x):
        return self.apply_ffn(x, self.w_in, self.w_gate, self.w_out,
                              self.activation)

    @staticmethod
    def apply_ffn(x, w_in, w_gate, w_out, activation):
        """``ExpertFFN.apply`` (moe.py:351), x ``[E, C, d_model]``. Each
        product sums in fp32 and returns x's dtype, as XLA's dot of bf16
        operands does."""
        dt = x.dtype
        xf = x.float()
        h = torch.bmm(xf, w_in.float()).to(dt)
        if w_gate is not None:
            h = activation(torch.bmm(xf, w_gate.float()).to(dt)) * h
        else:
            h = activation(h)
        return torch.bmm(h.float(), w_out.float()).to(dt)


def _slot_structures(idx, pos, keep, E, C):
    """moe.py:491: copy i of token i // K goes to slot ``e * C + pos`` (or
    the dropped sentinel ``E * C``). Returns ``(slot [T*K], keep [T*K],
    fill_copy [E*C], occupied [E*C])``."""
    ec = E * C
    e_flat = idx.reshape(-1)
    keep_f = keep.reshape(-1)
    slot = torch.where(keep_f, e_flat * C + pos.reshape(-1),
                       torch.full_like(e_flat, ec))
    n = slot.shape[0]
    fill = torch.zeros((ec + 1,), dtype=torch.long, device=idx.device)
    fill[slot[keep_f]] = torch.arange(n, device=idx.device)[keep_f]
    occupied = torch.zeros((ec + 1,), dtype=torch.bool, device=idx.device)
    occupied[slot[keep_f]] = True
    return slot, keep_f, fill[:ec], occupied[:ec]


def moe_grouped_compute(x, idx, w, pos, keep, capacity, w_in, w_gate,
                        w_out, activation):
    """Capacity-packed grouped dispatch (counterpart: moe.py:462): token
    copies gathered into per-expert capacity slots, one batched FFN over
    ``[E, C, D]``, each kept copy read back by gather and combined with
    its weight in fp32. Plain tensor code in both packages (the JAX
    package leaves it to XLA); the gathers' backward is a scatter-add."""
    T, D = x.shape
    K = idx.shape[1]
    E = w_in.shape[0]
    C = int(capacity)
    slot, keep_f, fill_copy, occupied = _slot_structures(idx, pos, keep, E,
                                                         C)
    xe = torch.where(occupied[:, None], x[fill_copy // K],
                     torch.zeros((), dtype=x.dtype, device=x.device))
    ye = ExpertFFN.apply_ffn(xe.reshape(E, C, D), w_in, w_gate, w_out,
                             activation).reshape(E * C, D)
    back = torch.where(keep_f[:, None], ye[slot.clamp(max=E * C - 1)],
                       torch.zeros((), dtype=ye.dtype, device=x.device))
    out = back.float() * w.reshape(-1).float()[:, None]
    return out.reshape(T, K, D).sum(dim=1).to(x.dtype)


def moe_fused_compute(x, idx, w, pos, keep, capacity, w_in, w_gate, w_out,
                      activation):
    """Fused grouped-GEMM dispatch (counterpart: moe.py:506): the same
    contract as :func:`moe_grouped_compute` without the ``[E, C, D]``
    buffers; the capacity is padded to the kernels' block, which widens
    each expert's slot segment without admitting a dropped copy. Callers
    check ``fused_dispatch_applicable`` first."""
    T = x.shape[0]
    K = idx.shape[1]
    E = w_in.shape[0]
    cpad = padded_capacity(int(capacity))
    slot, _, fill_copy, occupied = _slot_structures(idx, pos, keep, E, cpad)
    row_id, gate_w = slot_maps(slot, fill_copy, occupied, w.reshape(-1), T,
                               E, cpad, K)
    return fused_grouped_moe(x.contiguous(), row_id, gate_w, w_in, w_gate,
                             w_out, act_name_of(activation))


class MoELayer(nn.Module):
    """Counterpart of moe.py:567 on one device: ``dispatch`` ``"grouped"``
    or ``"fused"``; the other dispatch modes raise. ``aux_loss`` holds
    the router's load-balance loss of the last forward."""

    def __init__(self, d_model, experts=None, gate="gshard", num_experts=8,
                 d_hidden=None, recompute_interval=0, ep_axis=None,
                 dispatch="einsum", *, device=None, dtype=None):
        super().__init__()
        if ep_axis is not None:
            raise NotImplementedError(f"expert sharding (ep_axis) "
                                      f"{_UNPORTED}")
        if dispatch not in ("grouped", "fused"):
            if dispatch in ("einsum", "alltoall", "ragged"):
                raise NotImplementedError(
                    f"dispatch={dispatch!r} {_UNPORTED}; the port has "
                    f"'grouped' and 'fused'")
            raise ValueError(f"dispatch must be 'einsum', 'alltoall', "
                             f"'ragged', 'grouped' or 'fused', got "
                             f"{dispatch!r}")
        d_hidden = d_hidden or 4 * d_model
        if isinstance(gate, str):
            gate = {"gshard": GShardGate, "switch": SwitchGate,
                    "naive": SwitchGate}[gate](d_model, num_experts,
                                               device=device)
        self.gate = gate
        self.dispatch = dispatch
        self.experts = experts if experts is not None else ExpertFFN(
            num_experts, d_model, d_hidden, device=device, dtype=dtype)
        if not isinstance(self.experts, ExpertFFN):
            raise ValueError(f"dispatch={dispatch!r} requires ExpertFFN "
                             f"experts")
        self.aux_loss = torch.zeros((), dtype=torch.float32)

    def forward(self, x):
        shape = x.shape
        t = x.reshape(-1, shape[-1])
        out, self.aux_loss = self._forward_sorted(t)
        return out.reshape(shape)

    def _forward_sorted(self, t):
        """moe.py:612 without a mesh: ``"fused"`` takes the fused dispatch
        (and the routing kernel) where ``fused_dispatch_applicable`` holds,
        else the grouped path with the plain routing chain."""
        experts = self.experts
        fused = self.dispatch == "fused" and fused_dispatch_applicable(
            t.shape[0], t.shape[1], experts.w_in.shape[2],
            self.gate.num_experts, self.gate.capacity(t.shape[0]),
            t.dtype, experts.activation, experts.gated)
        idx, w, pos, keep, aux, cap = self.gate.forward_sparse(
            t, impl="fused" if fused else "xla")
        compute = moe_fused_compute if fused else moe_grouped_compute
        out = compute(t, idx, w, pos, keep, cap, experts.w_in,
                      experts.w_gate, experts.w_out, experts.activation)
        return out, aux
