"""The GPT-2 pretraining slice against the JAX package, on the CPU.

A tiny GPT (vocab 512, hidden 64, 2 layers of 4 heads, FFN 256, 256
positions) is built in JAX from a seed, exported with ``state_dict`` and
loaded into the port with ``load_numpy_state``. The JAX model's flash
route is switched on (``_flash_backend_ok`` patched, as
``test_torch_train.py`` does), so at s 256 both packages take flash
attention (the JAX Pallas kernels in interpret mode, the port's plain
versions) and at s 32 both take the plain core; LayerNorm takes the JAX
Pallas kernel in interpret mode and the port's plain version.

- with dropout 0, and with dropout 0.1 in eval mode: logits and loss at
  s 32 and s 256 against the JAX model, and the route each package took;
- dropout 0: 3 ``TrainStep``s (AdamW) from one JAX ``state_dict`` at b 2 x
  s 256, the losses and every parameter after step 3;
- dropout 0.1 in training (the keep masks drawn from the model's
  generator, not ``jax.random``, so nothing to compare with JAX bit for
  bit): two runs from one seed are bitwise equal, another seed differs,
  the loss falls over 5 steps, and the run launches no kernel on the
  CPU;
- the strided fused-QKV views reach flash attention as views (no copy);
- the configuration helpers and the unported ``mp_axis``.

Inputs and labels come from numpy, seeded. Tolerances as in
``test_torch_bert.py``: fp32 logits 2e-5 relative and absolute (the same
arithmetic, sums in another order); training: the losses 2e-5 relative,
the parameters 1e-6 relative plus 0.1% of the 3 lr that three Adam steps
can move a weight, Adam's epsilon 1e-4 (near g = 0 a step moves a weight
by ``lr * g / (|g| + eps)``, which multiplies a summation-order
difference of the gradient by up to lr / eps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu.nn.functional import attention as jattn
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     export_numpy_state, gpt2_medium,
                                     gpt2_small, load_numpy_state)
from paddle_tpu_torch.ops.kernels import flash_attention as T
from paddle_tpu_torch.ops.kernels import launch_counts
from paddle_tpu_torch.optimizer import AdamW
from torch_one_thread import one_torch_thread  # noqa: F401

TINY = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=256,
            max_position_embeddings=256, mp_axis=None)
NO_DROP = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
B, STEPS, LR, EPS = 2, 3, 1e-3, 1e-4


@pytest.fixture(scope="module")
def flash_route():
    """JAX's flash route on; counts ``_flash_sharded`` calls."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jattn, "_flash_backend_ok", lambda: True)
    calls = [0]
    orig = jattn._flash_sharded

    def sharded(*a, **kw):
        calls[0] += 1
        return orig(*a, **kw)

    mp.setattr(jattn, "_flash_sharded", sharded)
    yield calls
    mp.undo()


def _jax_model(seed=21, **kw):
    pt.seed(seed)
    jm = JGPT(JGPTConfig(**{**TINY, **NO_DROP, **kw}))
    state = {k: np.asarray(v) for k, v in jm.state_dict(
        include_non_persistable_buffer=True).items()}
    return jm, state


def _port_model(state, **kw):
    tm = GPTForCausalLM(GPTConfig(**{**TINY, **NO_DROP, **kw}),
                        device="cpu", seed=None)
    load_numpy_state(tm, state)
    return tm


def _ids(seed, s):
    return np.random.default_rng(seed).integers(
        0, TINY["vocab_size"], (B, s)).astype(np.int32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("s", [32, 256])
@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_forward_and_loss_match_jax(flash_route, s, dropout):
    """Dropout 0, or dropout 0.1 in eval mode (both models): the same
    logits and loss; at s 256 both took flash attention."""
    drop = dict(hidden_dropout_prob=dropout,
                attention_probs_dropout_prob=dropout)
    jm, state = _jax_model(**drop)
    tm = _port_model(state, **drop)
    jm.eval()
    tm.eval()
    ids = _ids(s, s)
    before = flash_route[0]
    jlogits = jm(jnp.asarray(ids))
    counts = launch_counts()
    tlogits = tm(torch.tensor(ids))
    assert launch_counts() == counts    # the CPU path launches no kernel
    assert flash_route[0] - before == (TINY["num_hidden_layers"]
                                       if s >= 256 else 0)
    assert tlogits.dtype == torch.float32
    np.testing.assert_allclose(_np(tlogits), _np(jlogits), rtol=2e-5,
                               atol=2e-5)
    jloss = jm.loss(jlogits, jnp.asarray(ids))
    tloss = tm.loss(tlogits, torch.tensor(ids).long())
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=2e-5)


def test_train_step_matches_jax(flash_route):
    jm, state0 = _jax_model()
    ids = _ids(5, 256)
    before = flash_route[0]
    jstep = JTrainStep(jm, JAdamW(learning_rate=LR, epsilon=EPS,
                                  parameters=jm),
                       lambda logits, y: jm.loss(logits, y))
    jlosses = [float(jstep(ids, ids)) for _ in range(STEPS)]
    assert flash_route[0] > before
    jparams = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tm = _port_model(state0)
    step = TrainStep(tm, AdamW(learning_rate=LR, epsilon=EPS, parameters=tm),
                     lambda logits, y: tm.loss(logits, y))
    counts = launch_counts()
    losses = [step(ids, ids).item() for _ in range(STEPS)]
    assert launch_counts() == counts
    np.testing.assert_allclose(losses, jlosses, rtol=2e-5)
    assert losses[-1] < losses[0]
    got = export_numpy_state(tm)
    assert set(got) == set(jparams)
    for k, want in jparams.items():
        np.testing.assert_allclose(got[k], want, rtol=1e-6,
                                   atol=1e-3 * STEPS * LR, err_msg=k)


def _dropout_run(seed, n_steps=5, s=256):
    tm = GPTForCausalLM(GPTConfig(**TINY), device="cpu", seed=seed)
    step = TrainStep(tm, AdamW(learning_rate=LR, parameters=tm),
                     lambda logits, y: tm.loss(logits, y))
    ids = _ids(9, s)
    losses = [step(ids, ids).item() for _ in range(n_steps)]
    return losses, export_numpy_state(tm)


def test_dropout_training_is_reproducible_from_a_seed():
    """Dropout 0.1 in training (GPT-2's default): every mask and every
    attention-dropout key comes from the model's generator, so two runs
    from one seed are bitwise equal; another seed differs; the loss
    falls on a fixed batch."""
    counts = launch_counts()
    l1, p1 = _dropout_run(3)
    l2, p2 = _dropout_run(3)
    l3, _ = _dropout_run(4)
    assert launch_counts() == counts
    assert l1 == l2 and l1 != l3
    assert all(np.array_equal(p1[k], p2[k]) for k in p1)
    assert l1[-1] < l1[0]


def test_dropout_masks_come_from_the_generator():
    """In training the same weights give different logits for different
    generator states, and the same logits for one state; eval mode
    draws nothing."""
    tm = GPTForCausalLM(GPTConfig(**TINY), device="cpu", seed=0)
    ids = torch.tensor(_ids(1, 256))
    state = tm.generator.get_state()
    a = tm(ids)
    b = tm(ids)
    tm.generator.set_state(state)
    assert torch.equal(tm(ids), a) and not torch.equal(a, b)
    tm.eval()
    after = tm.generator.get_state()
    e = tm(ids)
    assert torch.equal(tm.generator.get_state(), after)
    assert torch.equal(tm(ids), e)
    for blk in tm.transformer.blocks:
        assert blk.generator is tm.generator
        assert blk.dropout.generator is tm.generator


def test_fused_qkv_views_reach_flash_as_views(monkeypatch):
    """The block's q, k, v are strided views of the fused projection; the
    flash path takes them as they are (the kernels read strides)."""
    tm = GPTForCausalLM(GPTConfig(**TINY, **NO_DROP), device="cpu", seed=0)
    seen = []
    orig = T._fwd

    def spy(q, k, v, *a, **kw):
        seen.append((q.is_contiguous(), q.stride()))
        return orig(q, k, v, *a, **kw)

    monkeypatch.setattr(T, "_fwd", spy)
    tm(torch.tensor(_ids(2, 256)))
    assert seen and all(not contiguous for contiguous, _ in seen)
    assert seen[0][1] == (256 * 3 * 64, 3 * 64, 16, 1)


def test_configs_and_unported_mp_axis():
    small, medium = gpt2_small(), gpt2_medium()
    assert (small.hidden_size, small.num_hidden_layers,
            small.num_attention_heads, small.intermediate_size,
            small.vocab_size, small.dtype, small.hidden_dropout_prob,
            small.attention_probs_dropout_prob) == (768, 12, 12, 3072,
                                                    50304, "float32", 0.1,
                                                    0.1)
    assert (medium.hidden_size, medium.num_hidden_layers,
            medium.num_attention_heads) == (1024, 24, 16)
    assert JGPTConfig().__dict__ == GPTConfig().__dict__
    with pytest.raises(NotImplementedError, match="mp_axis"):
        GPTForCausalLM(GPTConfig(**{**TINY, "mp_axis": "mp"}), device="cpu")
    tm = GPTForCausalLM(GPTConfig(**TINY), device="cpu", seed=0)
    n = sum(p.numel() for p in tm.parameters())
    assert tm.num_params() == n
    # GPT-2 small: 124,475,904 parameters (the tied head counted once)
    c = small
    blocks = c.num_hidden_layers * (
        4 * c.hidden_size + 3 * c.hidden_size * c.hidden_size
        + 3 * c.hidden_size + c.hidden_size * c.hidden_size + c.hidden_size
        + 2 * c.hidden_size * c.intermediate_size + c.intermediate_size
        + c.hidden_size)
    total = ((c.vocab_size + c.max_position_embeddings) * c.hidden_size
             + blocks + 2 * c.hidden_size)
    assert total == 124_475_904
