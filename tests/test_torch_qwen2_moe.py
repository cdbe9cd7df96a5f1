"""The Qwen2-MoE slice of the port against the JAX package, on the CPU.

A small ``Qwen2MoeForCausalLM`` with ``ep_dispatch="fused"``: D 128, 2
layers, 2 heads of 64 with 1 kv head, E 4 experts of H 64 (top-2), a
shared expert of 128, vocab 256, batch 2 x seq 512. T = 1024 tokens a
layer, so the JAX model takes both of its MoE Pallas kernels (the
routing kernel and the fused grouped GEMM, in interpret mode) and flash
attention; the port takes the same routes through the kernels' plain
versions. fp32 throughout. The JAX weights are exported and loaded into
the port.

The random keep of the second expert: the JAX key stream of the routers
is pinned to one key (``paddle_tpu.distributed.moe.rng``), and the port's
draw (``draw_uniform``) returns ``jax.random.uniform`` of that key, so
both packages keep the same second experts in every layer and step.

Checked, each with its tolerance:
- every layer's routing decisions (experts, positions, keeps) equal as
  integers; a row may differ only where its top-2 or keep2 margin is
  below ``MARGIN`` (fp32 ulps of a probability near 1: two softmaxes
  whose sums run in another order), and the test reports that margin;
- the forward's logits: ``atol 2e-5`` (fp32 sums in another order
  through two layers; measured ~2e-6);
- three ``TrainStep``s with AdamW: each loss ``rtol 2e-5``, the first
  step's gradients ``rtol 1e-4, atol 1e-6`` of each tensor's largest
  value, every parameter after step 3 ``rtol 1e-6`` plus 0.1% of what
  three Adam steps can move a weight (``epsilon = 1e-5``, for the reason
  given in ``tests/test_torch_train.py``).

The JAX side trains through a ``TrainStep`` whose objective takes the
routers' aux losses from the buffers its own forward returns. The stock
JAX ``TrainStep`` does not: ``Qwen2MoeForCausalLM.loss`` reads
``aux_loss`` from the module after ``functional_call`` has restored it,
so the load-balance term enters the objective as a constant from the
previous step and sends no gradient to the routers
(``test_jax_train_step_drops_the_aux_gradient`` shows it; ROADMAP.md C).
The port follows the model's stated objective.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.distributed.moe as jax_moe
import paddle_tpu.nn.functional as JF
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models.qwen2_moe import Qwen2MoeConfig as JaxConfig
from paddle_tpu.models.qwen2_moe import Qwen2MoeForCausalLM as JaxQwen
from paddle_tpu.nn.functional import attention as jattn
from paddle_tpu.nn.module import functional_call
from paddle_tpu.ops.pallas import moe_grouped_gemm as jax_gg
from paddle_tpu.optimizer import AdamW as JAdamW
import paddle_tpu_torch.distributed.moe as port_moe
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (Qwen2MoeConfig, Qwen2MoeForCausalLM,
                                     export_numpy_state, load_numpy_state)
from paddle_tpu_torch.ops.kernels import launch_counts
from paddle_tpu_torch.optimizer import AdamW
from torch_one_thread import one_torch_thread  # noqa: F401

B, S, STEPS, LR, EPS = 2, 512, 3, 1e-3, 1e-5
MARGIN = 1e-6
WIDTHS = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
              moe_intermediate_size=64, shared_expert_intermediate_size=128,
              num_hidden_layers=2, num_attention_heads=2,
              num_key_value_heads=1, num_experts=4, num_experts_per_tok=2,
              max_position_embeddings=S, ep_dispatch="fused",
              dtype="float32")
AUX_COEF = 0.001      # Qwen2MoeConfig.router_aux_loss_coef
KEY = jax.random.key(5)
T = B * S


def _record(mp, module, name, calls):
    orig = getattr(module, name)

    def rec(*a, **kw):
        out = orig(*a, **kw)
        calls.append((a, kw, out))
        return out
    mp.setattr(module, name, rec)


def _decisions(calls):
    """Per routed layer: (logits, idx, pos, keep) as numpy."""
    out = []
    for a, kw, res in calls:
        f = lambda t: (t.detach().numpy() if isinstance(t, torch.Tensor)
                       else np.asarray(t))
        g1, g2, _, _, k1, k2, p1, p2, _ = (f(t) for t in res)
        out.append((f(a[0]).astype(np.float32),
                    np.stack([g1, g2], 1).astype(np.int64),
                    np.stack([p1, p2], 1).astype(np.int64),
                    np.stack([k1, k2], 1)))
    return out


def _jax_objective(logits, labels, buffers):
    """``Qwen2MoeForCausalLM.loss`` with the aux losses of this forward."""
    ce = JF.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                          labels[:, 1:].reshape(-1))
    aux = sum(v for k, v in buffers.items() if k.endswith("moe.aux_loss"))
    return ce + AUX_COEF * aux


class _AuxTrainStep(JTrainStep):
    """The JAX TrainStep with the objective above."""

    def _loss_and_grads(self, params, buffers, key, *batch):
        def loss_of(p):
            out, nb = functional_call(self.model, {**buffers, **p}, batch[0],
                                      rngs=key, training=True)
            return _jax_objective(out, batch[1], nb), nb

        (loss, nb), grads = jax.value_and_grad(loss_of, has_aux=True)(params)
        return loss, None, grads, nb


@pytest.fixture(scope="module")
def jax_run():
    """The JAX model: its initial state, the batch, the forward's logits
    and routing, the first step's gradients, 3 steps' losses and the
    parameters after them."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jattn, "_flash_backend_ok", lambda: True)
    mp.setattr(jax_moe, "rng", SimpleNamespace(next_key=lambda: KEY))
    fused_calls, route_calls = [], []
    _record(mp, jax_gg, "fused_grouped_moe", fused_calls)
    _record(mp, jax_moe, "_top2_parts", route_calls)
    try:
        pt.seed(31)
        jm = JaxQwen(JaxConfig(mp_axis=None, fsdp_axis=None, ep_axis=None,
                               **WIDTHS))
        state0 = {k: np.asarray(v) for k, v in jm.state_dict(
            include_non_persistable_buffer=True).items()}
        ids = np.random.default_rng(6).integers(0, 256, (B, S)) \
            .astype(np.int32)
        jm.train()
        logits = np.asarray(jm(jnp.asarray(ids)))
        assert len(fused_calls) == 2, "the fused dispatch did not engage"
        assert all(kw.get("impl") == "fused" for _, kw, _ in route_calls)
        routing = _decisions(route_calls)
        opt = JAdamW(learning_rate=LR, epsilon=EPS, parameters=jm)
        step = _AuxTrainStep(jm, opt, None)
        args = (jm.param_dict(trainable_only=True), jm.buffer_dict(),
                jax.random.key(0), jnp.asarray(ids), jnp.asarray(ids))
        _, _, grads, _ = jax.jit(step._loss_and_grads)(*args)
        grads = {k: np.asarray(v) for k, v in grads.items()}
        stock = JTrainStep(jm, opt, lambda lg, y: jm.loss(lg, y))
        _, _, stock_grads, _ = jax.jit(stock._loss_and_grads)(*args)
        losses = [float(step(ids, ids)) for _ in range(STEPS)]
        params = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    finally:
        mp.undo()
    u = np.asarray(jax.random.uniform(KEY, (T,)))
    return dict(state0=state0, ids=ids, logits=logits, routing=routing,
                grads=grads, losses=losses, params=params, u=u,
                stock_router_grad=np.asarray(
                    stock_grads["layers.0.mlp.moe.gate.weight"]))


@pytest.fixture
def port(jax_run, monkeypatch):
    """A port model with the JAX weights, whose routers draw the JAX
    uniforms; its ``_top2_parts`` calls are recorded."""
    u = torch.tensor(jax_run["u"])
    monkeypatch.setattr(port_moe, "draw_uniform", lambda n, gen, dev: u)
    calls = []
    _record(monkeypatch, port_moe, "_top2_parts", calls)
    tm = Qwen2MoeForCausalLM(Qwen2MoeConfig(**WIDTHS), device="cpu",
                             seed=None)
    load_numpy_state(tm, jax_run["state0"])
    return tm, calls


def _row_margin(logits, u, i):
    """The smallest margin of row i's decisions: the gaps between its
    three largest probabilities and between u and its keep threshold."""
    p = np.exp(logits[i] - logits[i].max())
    p = np.sort(p / p.sum())[::-1]
    return min(p[0] - p[1], p[1] - p[2],
               abs(u[i] - 2 * p[1] / max(p[0] + p[1], 1e-9)))


def test_forward_routing_and_logits_match_jax(jax_run, port):
    tm, calls = port
    before = launch_counts()
    logits = tm(torch.tensor(jax_run["ids"]))
    assert launch_counts() == before
    got, want = _decisions(calls), jax_run["routing"]
    assert len(got) == len(want) == 2
    assert all(kw.get("impl") == "fused" for _, kw, _ in calls)
    for layer, (g, w) in enumerate(zip(got, want)):
        bad = np.nonzero((g[1] != w[1]).any(1) | (g[3] != w[3]).any(1))[0]
        margins = [_row_margin(w[0], jax_run["u"], i) for i in bad]
        assert all(m < MARGIN for m in margins), (layer, bad, margins)
        if not len(bad):
            np.testing.assert_array_equal(g[2], w[2])
    np.testing.assert_allclose(logits.detach().numpy(), jax_run["logits"],
                               rtol=0, atol=2e-5)


def test_train_steps_match_jax(jax_run, port):
    tm, _ = port
    ids = jax_run["ids"]
    opt = AdamW(learning_rate=LR, epsilon=EPS, parameters=tm)
    step = TrainStep(tm, opt, lambda lg, y: tm.loss(lg, y))
    losses = []
    for i in range(STEPS):
        losses.append(step(ids, ids).item())
        if i == 0:
            for k, want in jax_run["grads"].items():
                g = dict(tm.named_parameters())[k].grad.numpy()
                np.testing.assert_allclose(
                    g, want, rtol=1e-4, atol=1e-6 * np.abs(want).max(),
                    err_msg=k)
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=2e-5)
    assert losses[-1] < losses[0]
    got = export_numpy_state(tm)
    assert set(got) == set(jax_run["params"])
    for k, want in jax_run["params"].items():
        np.testing.assert_allclose(got[k], want, rtol=1e-6,
                                   atol=1e-3 * STEPS * LR, err_msg=k)
    router = dict(tm.named_parameters())["layers.0.mlp.moe.gate.weight"]
    assert router.grad is not None and router.grad.abs().sum() > 0


def test_wider_fp32_forward_matches_jax(monkeypatch):
    """One sparse layer at D 256 with experts of H 128 (a multiple of
    64, as the fp32 slice's 512), fp32, b 2 x s 512, in train mode: both
    packages take the fused dispatch (the JAX model its fp32 Pallas
    kernels in interpret mode), route alike (``MARGIN``) and give the
    same logits (``atol 2e-5``)."""
    widths = dict(WIDTHS, hidden_size=256, moe_intermediate_size=128,
                  shared_expert_intermediate_size=256, num_hidden_layers=1)
    mp = pytest.MonkeyPatch()
    mp.setattr(jattn, "_flash_backend_ok", lambda: True)
    mp.setattr(jax_moe, "rng", SimpleNamespace(next_key=lambda: KEY))
    jax_fused, jax_routes = [], []
    _record(mp, jax_gg, "fused_grouped_moe", jax_fused)
    _record(mp, jax_moe, "_top2_parts", jax_routes)
    try:
        pt.seed(37)
        jm = JaxQwen(JaxConfig(mp_axis=None, fsdp_axis=None, ep_axis=None,
                               **widths))
        state0 = {k: np.asarray(v) for k, v in jm.state_dict(
            include_non_persistable_buffer=True).items()}
        ids = np.random.default_rng(8).integers(0, 256, (B, S))
        jm.train()
        want = np.asarray(jm(jnp.asarray(ids.astype(np.int32))))
    finally:
        mp.undo()
    assert len(jax_fused) == 1
    u = torch.tensor(np.asarray(jax.random.uniform(KEY, (T,))))
    monkeypatch.setattr(port_moe, "draw_uniform", lambda n, gen, dev: u)
    fused, routes = [], []
    _record(monkeypatch, port_moe, "moe_fused_compute", fused)
    _record(monkeypatch, port_moe, "_top2_parts", routes)
    tm = Qwen2MoeForCausalLM(Qwen2MoeConfig(**widths), device="cpu",
                             seed=None)
    load_numpy_state(tm, state0)
    got = tm(torch.tensor(ids)).detach().numpy()
    assert len(fused) == 1
    (g,), (w,) = _decisions(routes), _decisions(jax_routes)
    bad = np.nonzero((g[1] != w[1]).any(1) | (g[3] != w[3]).any(1))[0]
    margins = [_row_margin(w[0], u.numpy(), i) for i in bad]
    assert all(m < MARGIN for m in margins), (bad, margins)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_jax_train_step_drops_the_aux_gradient(jax_run, port):
    """The stock JAX TrainStep's router gradient is the port's with the
    aux loss held constant: the reference-side fault above."""
    tm, _ = port
    ids = torch.tensor(jax_run["ids"]).long()
    logits = tm(ids)
    ce = tm.loss(logits, ids) - AUX_COEF * tm.aux_loss()
    (ce + AUX_COEF * tm.aux_loss().detach()).backward()
    got = dict(tm.named_parameters())["layers.0.mlp.moe.gate.weight"].grad
    want = jax_run["stock_router_grad"]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-6 * np.abs(want).max())
    full = jax_run["grads"]["layers.0.mlp.moe.gate.weight"]
    assert np.abs(full - want).max() > 0.1 * np.abs(want).max()


def test_tiny_config_takes_the_grouped_fallback_like_jax(monkeypatch):
    """``qwen2_moe_tiny`` (D 64) fails the fused gate's ``D % 128`` in both
    packages, so ``ep_dispatch="fused"`` runs the grouped path and the
    plain routing chain; eval mode keeps every second expert. Logits
    ``atol 2e-5`` as above."""
    from paddle_tpu.models.qwen2_moe import qwen2_moe_tiny as jax_tiny
    from paddle_tpu_torch.models import qwen2_moe_tiny
    pt.seed(2)
    jm = JaxQwen(jax_tiny(mp_axis=None, fsdp_axis=None, ep_axis=None,
                          ep_dispatch="fused"))
    jm.eval()
    ids = np.random.default_rng(3).integers(0, 256, (2, 16))
    want = np.asarray(jm(jnp.asarray(ids)))
    fused = []
    _record(monkeypatch, port_moe, "moe_fused_compute", fused)
    tm = Qwen2MoeForCausalLM(qwen2_moe_tiny(ep_dispatch="fused"),
                             device="cpu", seed=None)
    load_numpy_state(tm, {k: np.asarray(v) for k, v in jm.state_dict(
        include_non_persistable_buffer=True).items()})
    tm.eval()
    got = tm(torch.tensor(ids)).detach().numpy()
    assert not fused
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_unported_moe_options_raise():
    from paddle_tpu_torch.distributed.moe import ExpertFFN, MoELayer, TopKGate
    from paddle_tpu_torch.models import qwen2_moe_tiny
    for dispatch in ("einsum", "ragged", "alltoall"):
        with pytest.raises(NotImplementedError, match="A10"):
            MoELayer(64, num_experts=4, dispatch=dispatch, device="cpu")
    with pytest.raises(NotImplementedError, match="A10"):
        qwen2_moe_tiny(ep_axis="mp")
    with pytest.raises(NotImplementedError, match="A10"):
        ExpertFFN(4, 64, 32, ep_axis="mp")
    gate = TopKGate(64, 4, top_k=1)
    with pytest.raises(NotImplementedError, match="top-1"):
        gate.forward_sparse(torch.zeros((8, 64)))
    with pytest.raises(NotImplementedError, match="one-hot"):
        gate(torch.zeros((8, 64)))


def test_top_k_above_two_routes_top2_with_its_capacity():
    """As the JAX gate (moe.py:259, :300): ``top_k=4`` routes two experts
    a token but sizes the capacity for four."""
    from paddle_tpu.distributed.moe import TopKGate as JaxGate
    from paddle_tpu_torch.distributed.moe import TopKGate
    pt.seed(4)
    jg, tg = JaxGate(64, 8, top_k=4), TopKGate(64, 8, top_k=4)
    assert tg.capacity(1000) == jg.capacity(1000) == 625
    tg.eval()
    idx, w, pos, keep, aux, cap = tg.forward_sparse(torch.randn(16, 64))
    assert idx.shape == w.shape == (16, 2) and cap == tg.capacity(16)
