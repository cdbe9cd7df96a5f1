"""The port's training path against the JAX package, on the CPU.

- RMSNorm autograd (the port's Function, plain forward on the CPU)
  against ``jax.grad`` of ``fused_rms_norm`` (Pallas forward in interpret
  mode, closed-form ``_rms_bwd``), for dx and dw;
- hard-label ``cross_entropy`` with ``ignore_index``: value and gradient;
- Adam and AdamW over 3 steps, bf16 parameters (fp32 master copies) and
  fp32 ones, against ``update`` of the JAX optimizers, from a fresh state
  and from a JAX state carried over after 2 steps;
- the slice as a whole: ``llama_tiny`` in fp32 at b 2 x s 256 (so both
  packages take flash attention: the JAX Pallas kernels in interpret
  mode, the port's plain versions), 3 ``TrainStep``s each from one JAX
  ``state_dict``: the three losses and every parameter after step 3;
- a parameter the loss does not use: ``jax.value_and_grad`` gives it a
  zero gradient and AdamW decays it by ``1 - lr * weight_decay`` a step;
  the port's ``TrainStep`` does the same (it once left such a
  parameter's ``.grad`` None, which the optimizer skips), and takes the
  labels as a nested tuple of numpy arrays, as ``bench_bert`` passes
  them.

Inputs, weights and gradients come from numpy, seeded.

Tolerances: fp32 values 1e-5 relative (2e-5 for the model's losses): the
same arithmetic with sums taken in another order. bf16 values: one bf16
ulp (``rtol = 2**-7``). The model's parameters after 3 steps: 1e-6
relative (a few fp32 ulps of the weight) plus 0.1% of the most that 3
Adam steps can move a weight (``3 * lr``). The model's optimizer uses
``epsilon = 1e-5`` instead of 1e-8: with a tiny epsilon Adam's first step
moves a weight by ``lr * g / (|g| + eps)``, about the sign of ``g`` for
gradients near 0, where a summation-order difference of 1e-10 can flip
it (measured: 2.3e-5 at 1e-8, 1.6e-6 at 1e-6, 9.5e-7 at 1e-5); at 1e-5
the map is smooth there, so the comparison checks the arithmetic and not
the sign of rounding noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_tiny
from paddle_tpu.nn.functional import attention as jattn
from paddle_tpu.ops.pallas.fused_norm import fused_rms_norm
from paddle_tpu.optimizer import Adam as JAdam
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     export_numpy_state, llama_tiny,
                                     load_numpy_state, load_optimizer_state)
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.nn.functional import cross_entropy, rms_norm
from paddle_tpu_torch.ops.kernels import launch_counts
from paddle_tpu_torch.optimizer import Adam, AdamW
from torch_one_thread import one_torch_thread  # noqa: F401

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a: np.ndarray, dtype: str):
    """``a`` rounded to ``dtype``, as (jax, torch) arrays of equal value."""
    a = np.asarray(jnp.asarray(a, JDT[dtype]).astype(jnp.float32))
    return jnp.asarray(a, JDT[dtype]), torch.tensor(a).to(TDT[dtype])


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, dtype, rtol=1e-5, atol=1e-6):
    if dtype == "bfloat16":
        rtol, atol = 2 ** -7, 1e-6
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [128, 256])
def test_rms_norm_autograd_matches_jax_grad(d, dtype):
    rng = np.random.default_rng(d)
    jx, tx = _pair(rng.standard_normal((3, 5, d)) * 3, dtype)
    jw, tw = _pair(rng.standard_normal(d), dtype)
    jc, tc = _pair(rng.standard_normal((3, 5, d)), "float32")

    def jloss(x, w):
        return jnp.sum(fused_rms_norm(x, w, 1e-6).astype(jnp.float32) * jc)

    jdx, jdw = jax.grad(jloss, argnums=(0, 1))(jx, jw)
    x = tx.clone().requires_grad_(True)
    w = tw.clone().requires_grad_(True)
    before = launch_counts()
    (rms_norm(x, w, 1e-6).float() * tc).sum().backward()
    assert launch_counts() == before
    assert x.grad.dtype == TDT[dtype] and w.grad.dtype == TDT[dtype]
    _close(x.grad, jdx, dtype, rtol=1e-5, atol=1e-5)
    _close(w.grad, jdw, dtype, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_without_grad_matches_jax(dtype):
    """Under no_grad (the serving path) the router skips the autograd
    Function: no graph, the same values as the JAX forward."""
    rng = np.random.default_rng(5)
    jx, tx = _pair(rng.standard_normal((4, 7, 256)) * 3, dtype)
    jw, tw = _pair(rng.standard_normal(256), dtype)
    with torch.no_grad():
        y = rms_norm(tx, tw.requires_grad_(True), 1e-6)
    assert y.grad_fn is None and y.dtype == TDT[dtype]
    _close(y, fused_rms_norm(jx, jw, 1e-6), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_matches_jax(dtype):
    rng = np.random.default_rng(11)
    jx, tx = _pair(rng.standard_normal((2, 6, 50)) * 4, dtype)
    labels = rng.integers(0, 50, (2, 6))
    labels[0, 1] = labels[1, 4] = -100
    labels[1, 5] = 7
    jlab, tlab = jnp.asarray(labels), torch.tensor(labels)
    for reduction in ("mean", "sum", "none"):
        jval, jgrad = jax.value_and_grad(
            lambda x: jnp.sum(JF.cross_entropy(x, jlab,
                                               reduction=reduction)))(jx)
        x = tx.clone().requires_grad_(True)
        val = cross_entropy(x, tlab, reduction=reduction)
        val.sum().backward()
        assert x.grad.dtype == TDT[dtype]
        np.testing.assert_allclose(val.sum().item(), float(jval), rtol=1e-5)
        _close(x.grad, jgrad, dtype)
        assert (x.grad[0, 1] == 0).all() and (x.grad[1, 4] == 0).all()
    with pytest.raises(NotImplementedError):
        cross_entropy(tx, tlab, label_smoothing=0.1)


def _opt_problem(seed):
    """Two parameters, bf16 (master copy) and fp32, and 3 steps of
    gradients."""
    rng = np.random.default_rng(seed)
    params = {"w": _pair(rng.standard_normal((4, 8)), "bfloat16"),
              "b": _pair(rng.standard_normal(8), "float32")}
    grads = [{k: _pair(rng.standard_normal(v[1].shape) * 0.1,
                       str(v[1].dtype).split(".")[-1])
              for k, v in params.items()} for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("kind", ["Adam", "AdamW"])
def test_optimizer_matches_jax_update(kind, carried):
    """3 steps; with ``carried`` the port starts from the JAX state after
    2 steps (step count, moments, master copies) and takes the third."""
    jcls, tcls = {"Adam": (JAdam, Adam), "AdamW": (JAdamW, AdamW)}[kind]
    kw = dict(learning_rate=0.01, weight_decay=0.1)
    params, grads = _opt_problem(5)
    jopt, topt = jcls(**kw), tcls(**kw)
    jp = {k: v[0] for k, v in params.items()}
    tp = {k: v[1].clone() for k, v in params.items()}
    jstate = jopt.init_state(jp)
    tstate = topt.init_state(tp)
    assert tstate["master"]["b"] is None
    for i, g in enumerate(grads):
        if carried and i == 2:
            tp = {k: torch.tensor(np.asarray(v.astype(jnp.float32)))
                  .to(params[k][1].dtype) for k, v in jp.items()}
            topt.params = tp
            load_optimizer_state(topt, jax.tree.map(np.asarray, jstate))
            tstate = topt.state
            assert tstate["step"] == 2
        jp, jstate = jopt.update(jp, {k: v[0] for k, v in g.items()},
                                 jstate)
        if not carried or i == 2:
            out, _ = topt.update(tp, {k: v[1] for k, v in g.items()},
                                 tstate)
            assert out is tp   # in place
    assert tstate["step"] == 3 and tp["w"].dtype == torch.bfloat16
    for k in jp:
        _close(tp[k], jp[k], "bfloat16" if k == "w" else "float32")
        for slot in ("moment1", "moment2"):
            _close(tstate[slot][k], jstate[slot][k], "float32")
    _close(tstate["master"]["w"], jstate["master"]["w"], "float32")


def test_config_and_optimizer_raise_on_unported_options():
    with pytest.raises(NotImplementedError, match="recompute"):
        llama_tiny(recompute=True)
    with pytest.raises(NotImplementedError, match="parallelism"):
        LlamaConfig(mp_axis="mp")
    with pytest.raises(NotImplementedError, match="learning rate"):
        AdamW(learning_rate=lambda step: 0.1)
    with pytest.raises(NotImplementedError, match="grad_clip"):
        AdamW(grad_clip=object())


B, S, STEPS, LR, EPS = 2, 256, 3, 1e-3, 1e-5


@pytest.fixture(scope="module")
def jax_run():
    """The JAX TrainStep on llama_tiny: the initial state, the batch, and
    the losses and parameters after each of 3 steps."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jattn, "_flash_backend_ok", lambda: True)
    calls = []
    orig = jattn._flash_sharded
    mp.setattr(jattn, "_flash_sharded",
               lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    try:
        pt.seed(21)
        jm = JaxLlama(jax_tiny(dtype="float32", mp_axis=None,
                               fsdp_axis=None))
        state0 = {k: np.asarray(v) for k, v in jm.state_dict(
            include_non_persistable_buffer=True).items()}
        opt = JAdamW(learning_rate=LR, epsilon=EPS, parameters=jm)
        step = JTrainStep(jm, opt, lambda logits, y: jm.loss(logits, y))
        ids = np.random.default_rng(4).integers(0, 512, (B, S)) \
            .astype(np.int32)
        losses = [float(step(ids, ids)) for _ in range(STEPS)]
        params = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    finally:
        mp.undo()
    assert calls, "the JAX model did not take its flash kernel"
    return state0, ids, losses, params


def _port_model(state0):
    tm = LlamaForCausalLM(llama_tiny(), device="cpu", seed=None)
    load_numpy_state(tm, state0)
    return tm


def test_train_step_matches_jax(jax_run):
    state0, ids, jlosses, jparams = jax_run
    tm = _port_model(state0)
    opt = AdamW(learning_rate=LR, epsilon=EPS, parameters=tm)
    step = TrainStep(tm, opt, lambda logits, y: tm.loss(logits, y))
    before = launch_counts()
    losses = [step(ids, ids).item() for _ in range(STEPS)]
    assert launch_counts() == before   # the CPU path launches no kernel
    assert step.host_step == STEPS and opt.state["step"] == STEPS
    np.testing.assert_allclose(losses, jlosses, rtol=2e-5)
    assert losses[-1] < losses[0]
    got = export_numpy_state(tm)
    assert set(got) == set(jparams)
    for k, want in jparams.items():
        np.testing.assert_allclose(got[k], want, rtol=1e-6,
                                   atol=1e-3 * STEPS * LR, err_msg=k)


def test_train_step_grads_reach_every_parameter(jax_run):
    """The RMSNorm weights included: each parameter's gradient after one
    step is finite and not all zero."""
    state0, ids, _, _ = jax_run
    tm = _port_model(state0)
    step = TrainStep(tm, AdamW(learning_rate=LR, parameters=tm),
                     lambda logits, y: tm.loss(logits, y))
    step(ids, ids)
    for name, p in tm.named_parameters():
        assert p.grad is not None, name
        assert torch.isfinite(p.grad).all() and p.grad.abs().sum() > 0, name


class _JaxTwo(jnn.Layer):
    """Two linears; the forward uses only the first."""

    def __init__(self):
        super().__init__()
        self.used = jnn.Linear(4, 3)
        self.unused = jnn.Linear(4, 3)

    def forward(self, x):
        return self.used(x)


class _PortTwo(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.used = Linear(4, 3, device="cpu", dtype=torch.float32)
        self.unused = Linear(4, 3, device="cpu", dtype=torch.float32)

    def forward(self, x):
        return self.used(x)


def test_train_step_decays_an_unused_parameter_as_jax():
    """2 AdamW steps (lr 1e-3, weight decay 0.01) in both packages from
    one state: the unused linear ends at ``(1 - lr * wd)**2`` times its
    start in both, exactly as JAX has it; the used one agrees to 1e-6.
    The labels come as a nested tuple of numpy arrays."""
    lr, wd = 1e-3, 0.01
    pt.seed(3)
    jm = _JaxTwo()
    state0 = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    rng = np.random.default_rng(8)
    x = rng.standard_normal((6, 4)).astype(np.float32)
    y = rng.standard_normal((6, 3)).astype(np.float32)

    def jloss(out, labels):
        (target,) = labels
        return jnp.mean((out - target) ** 2)

    jstep = JTrainStep(jm, JAdamW(learning_rate=lr, weight_decay=wd,
                                  parameters=jm), jloss)
    for _ in range(2):
        jstep(x, (y,))
    jparams = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tm = _PortTwo()
    load_numpy_state(tm, state0)
    step = TrainStep(tm, AdamW(learning_rate=lr, weight_decay=wd,
                               parameters=tm),
                     lambda out, labels: ((out - labels[0]) ** 2).mean())
    for _ in range(2):
        step(x, (y,))
    got = export_numpy_state(tm)
    for k in ("unused.weight", "unused.bias"):
        np.testing.assert_allclose(jparams[k], state0[k] * (1 - lr * wd) ** 2,
                                   rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(got[k], jparams[k], rtol=1e-7, atol=0,
                                   err_msg=k)
    for k in ("used.weight", "used.bias"):
        np.testing.assert_allclose(got[k], jparams[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    assert (tm.unused.weight.grad == 0).all()
