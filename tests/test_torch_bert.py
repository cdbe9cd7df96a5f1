"""The BERT pretraining slice against the JAX package, on the CPU.

A tiny BERT (vocab 512, hidden 128, 2 heads of head_dim 64, 2 layers,
FFN 256, max positions 512, both dropouts 0) is built in JAX from a
seed, exported with ``state_dict`` and loaded into the port with
``load_numpy_state``. The JAX model's flash route is switched on
(``_flash_backend_ok`` patched, as ``test_torch_train.py`` does), so at
s 256 both packages take flash attention: the JAX Pallas kernels in
interpret mode, with a padding mask in their bias mode
(``_flash_bias``), and the port's plain versions; LayerNorm takes the
JAX Pallas kernel in interpret mode (d 128) and the port's plain
version. Each test asserts the route the JAX side took.

- forward logits (MLM and NSP) at s 256 without and with a padding
  mask, and at s 128, where both take the plain core; a bf16 forward;
  ``BertForSequenceClassification``;
- three ``TrainStep``s of each arm of ``chip_smoke.py``'s BERT phases at
  b 2 x s 256: (a) ``bench.py::bench_bert``'s step (input ids only, MLM
  labels over the whole vocabulary), (b) a padded batch (seeded valid
  lengths, token types split inside each row, MLM labels -100 on
  padding): the losses and every parameter after step 3, the unused
  ``token_type_embeddings`` of arm (a) included (decayed by AdamW in
  both);
- gradients reach every parameter the padded batch uses, and the CPU
  path launches no kernel.

Inputs and labels come from numpy, seeded.

Tolerances: fp32 logits 2e-5 relative and absolute (the same arithmetic
with sums in another order); training as in ``test_torch_train.py``
(losses 2e-5 relative; parameters 1e-6 relative plus 0.1% of the 3 lr
that three Adam steps can move a weight). Adam's epsilon is 1e-4 here,
for the reason ``test_torch_train.py`` gives for its 1e-5: near g = 0 a
step moves a weight by ``lr * g / (|g| + eps)``, which multiplies a
summation-order difference of the gradient by up to lr / eps. BERT's
gradients are larger than the tiny Llama's (its MLM logits go through
an N(0, 1) tied embedding; the loss starts near 30), and so are their
rounding differences: at 1e-5 the weights parted by up to 6.1e-6
(``mlm_transform.weight``; the key projections' biases, whose exact
gradient is 0 since the softmax cancels a bias added to a whole score
row, by 5.1e-6), at 1e-4 by 1.4e-6, the losses by 2e-7 relative at
either. bf16
forward: each logit within 2**-6 of the summed magnitudes of the terms
of its last product (``|h| @ |W|``; measured: at most 0.005 of it), and
the MLM logits within 2% in relative Frobenius norm (measured 0.0075).
Every product, GELU, LayerNorm and residual add rounds to bf16 in both,
at points that differ (XLA's bf16 erf against PyTorch's fp32 erf rounded
once), so each input of the last product differs by a few bf16 ulps;
the NSP logits are small differences of such sums, so a bound relative
to the logit itself would measure cancellation, not the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models.bert import BertConfig as JBertConfig
from paddle_tpu.models.bert import BertForPreTraining as JBertPT
from paddle_tpu.models.bert import \
    BertForSequenceClassification as JBertCls
from paddle_tpu.nn.functional import attention as jattn
from paddle_tpu.ops.pallas import flash_attention as jflash
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (BertConfig, BertForPreTraining,
                                     BertForSequenceClassification,
                                     export_numpy_state, load_numpy_state)
from paddle_tpu_torch.ops.kernels import launch_counts
from paddle_tpu_torch.optimizer import AdamW
from torch_one_thread import one_torch_thread  # noqa: F401

TINY = dict(vocab_size=512, hidden_size=128, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=256,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
            max_position_embeddings=512)
B, S, STEPS, LR, EPS = 2, 256, 3, 1e-3, 1e-4


@pytest.fixture(scope="module")
def flash_route():
    """JAX's flash route on; counts ``_flash_sharded`` and ``_flash_bias``
    calls (the Pallas bias mode)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jattn, "_flash_backend_ok", lambda: True)
    calls = {"flash": 0, "bias": 0}
    orig_sharded, orig_bias = jattn._flash_sharded, jflash._flash_bias

    def sharded(*a, **kw):
        calls["flash"] += 1
        return orig_sharded(*a, **kw)

    def bias(*a, **kw):
        calls["bias"] += 1
        return orig_bias(*a, **kw)

    mp.setattr(jattn, "_flash_sharded", sharded)
    mp.setattr(jflash, "_flash_bias", bias)
    yield calls
    mp.undo()


def _jax_model(cls=JBertPT, seed=31, **kw):
    pt.seed(seed)
    jm = cls(JBertConfig(**{**TINY, **kw}))
    state = {k: np.asarray(v) for k, v in jm.state_dict(
        include_non_persistable_buffer=True).items()}
    return jm, state


def _port_model(state, cls=BertForPreTraining, **kw):
    tm = cls(BertConfig(**{**TINY, **kw}), device="cpu", seed=None)
    load_numpy_state(tm, state)
    return tm


def _batch(seed, s=S, padded=False):
    """(ids, token types, mask, mlm labels, nsp labels) as numpy; the
    padded batch's valid lengths are uniform in [s/2, s], its token
    types 0 up to a split point inside each row and 1 after it (0 on
    padding), its MLM labels -100 on padding."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, TINY["vocab_size"], (B, s)).astype(np.int32)
    mlm = rng.integers(0, TINY["vocab_size"], (B, s)).astype(np.int32)
    nsp = rng.integers(0, 2, (B,)).astype(np.int32)
    if not padded:
        return ids, None, None, mlm, nsp
    lens = rng.integers(s // 2, s + 1, B)
    split = rng.integers(1, lens - 1)
    pos = np.arange(s)[None, :]
    mask = (pos < lens[:, None]).astype(np.int32)
    tt = ((pos >= split[:, None]) & (mask > 0)).astype(np.int32)
    ids = np.where(mask > 0, ids, 0).astype(np.int32)
    mlm = np.where(mask > 0, mlm, -100).astype(np.int32)
    return ids, tt, mask, mlm, nsp


def _t(a):
    return None if a is None else torch.tensor(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("s,padded", [(256, False), (256, True),
                                      (128, True)])
def test_forward_matches_jax(flash_route, s, padded):
    jm, state = _jax_model()
    tm = _port_model(state)
    ids, tt, mask, _, _ = _batch(s, s, padded)
    before = dict(flash_route)
    jout = jm(_j(ids), _j(tt), _j(mask))
    counts = launch_counts()
    tout = tm(_t(ids), _t(tt), _t(mask))
    assert launch_counts() == counts   # the CPU path launches no kernel
    n_layers = TINY["num_hidden_layers"]
    flash = s >= 256
    assert flash_route["flash"] - before["flash"] == (n_layers if flash
                                                      else 0)
    assert flash_route["bias"] - before["bias"] == (
        n_layers if flash and padded else 0)
    for got, want in zip(tout, jout):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5,
                                   atol=2e-5)


def test_bf16_forward_matches_jax(flash_route):
    jm, state = _jax_model(dtype="bfloat16")
    tm = _port_model(state, dtype="bfloat16")
    assert tm.bert.embeddings.layer_norm.weight.dtype == torch.bfloat16
    ids, tt, mask, _, _ = _batch(5, padded=True)
    jmlm, jnsp = jm(_j(ids), _j(tt), _j(mask))
    tmlm, tnsp = tm(_t(ids), _t(tt), _t(mask))
    assert tmlm.dtype == torch.bfloat16
    with torch.no_grad():   # the inputs of each logit's last product
        seq, pooled = tm.bert(_t(ids), _t(tt), _t(mask))
        h = tm.mlm_norm(torch.nn.functional.gelu(tm.mlm_transform(seq)))
    terms = {"mlm": _np(h).__abs__() @ _np(
        tm.bert.embeddings.word_embeddings.weight).__abs__().T,
             "nsp": _np(pooled).__abs__() @ _np(
                 tm.nsp_head.weight).__abs__()}
    for name, got, want in (("mlm", tmlm, jmlm), ("nsp", tnsp, jnsp)):
        diff = np.abs(_np(got) - _np(want))
        assert (diff <= 2 ** -6 * terms[name]).all(), (
            name, (diff / terms[name]).max())
    rel = np.linalg.norm(_np(tmlm) - _np(jmlm)) / np.linalg.norm(_np(jmlm))
    assert rel <= 0.02, rel


def test_sequence_classification_matches_jax(flash_route):
    jm, state = _jax_model(JBertCls, seed=7)
    tm = _port_model(state, BertForSequenceClassification)
    ids, tt, mask, _, _ = _batch(9, padded=True)
    np.testing.assert_allclose(_np(tm(_t(ids), _t(tt), _t(mask))),
                               _np(jm(_j(ids), _j(tt), _j(mask))),
                               rtol=2e-5, atol=2e-5)


def _loss_fn(model):
    def loss(outputs, labels):
        mlm_logits, nsp_logits = outputs
        mlm_labels, nsp_labels = labels
        return model.loss(mlm_logits, nsp_logits, mlm_labels, nsp_labels)
    return loss


def _args(batch):
    """The TrainStep arguments of one arm: bench_bert's ``(ids, (mlm,
    nsp))`` or the padded ``(ids, token types, mask, (mlm, nsp))``."""
    ids, tt, mask, mlm, nsp = batch
    if mask is None:
        return (ids, (mlm, nsp)), 1
    return (ids, tt, mask, (mlm, nsp)), 3


@pytest.fixture(scope="module", params=["bench", "padded"])
def jax_run(request, flash_route):
    """The JAX TrainStep on the tiny BERT: the initial state, the batch,
    and the losses and parameters after 3 steps."""
    padded = request.param == "padded"
    jm, state0 = _jax_model()
    batch = _batch(40 + padded, padded=padded)
    args, n_inputs = _args(batch)
    before = dict(flash_route)
    step = JTrainStep(jm, JAdamW(learning_rate=LR, epsilon=EPS,
                                 parameters=jm), _loss_fn(jm),
                      n_inputs=n_inputs)
    losses = [float(step(*args)) for _ in range(STEPS)]
    assert flash_route["flash"] > before["flash"]
    assert (flash_route["bias"] > before["bias"]) == padded
    params = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    return state0, batch, losses, params


def test_train_step_matches_jax(jax_run):
    state0, batch, jlosses, jparams = jax_run
    tm = _port_model(state0)
    opt = AdamW(learning_rate=LR, epsilon=EPS, parameters=tm)
    args, n_inputs = _args(batch)
    step = TrainStep(tm, opt, _loss_fn(tm), n_inputs=n_inputs)
    before = launch_counts()
    losses = [step(*args).item() for _ in range(STEPS)]
    assert launch_counts() == before   # the CPU path launches no kernel
    np.testing.assert_allclose(losses, jlosses, rtol=2e-5)
    assert losses[-1] < losses[0]
    got = export_numpy_state(tm)
    assert set(got) == set(jparams)
    for k, want in jparams.items():
        np.testing.assert_allclose(got[k], want, rtol=1e-6,
                                   atol=1e-3 * STEPS * LR, err_msg=k)
    tt = "bert.embeddings.token_type_embeddings.weight"
    if batch[1] is None:   # unused in arm (a): decayed only, in both
        np.testing.assert_allclose(
            got[tt], state0[tt] * (1 - LR * 0.01) ** STEPS, rtol=1e-6)
        np.testing.assert_allclose(got[tt], jparams[tt], rtol=1e-7, atol=0)


def test_padded_grads_reach_every_parameter(jax_run):
    """One padded step: every parameter's gradient is finite and not all
    zero, the tied word embedding's holding the lookup's and the MLM
    product's contributions in one ``.grad``."""
    state0, _, _, _ = jax_run
    tm = _port_model(state0)
    args, n_inputs = _args(_batch(41, padded=True))
    step = TrainStep(tm, AdamW(learning_rate=LR, parameters=tm),
                     _loss_fn(tm), n_inputs=n_inputs)
    step(*args)
    for name, p in tm.named_parameters():
        assert p.grad is not None, name
        assert torch.isfinite(p.grad).all() and p.grad.abs().sum() > 0, name
    # the word embedding's gradient is the sum of both uses
    ids, tt, mask, mlm, nsp = (_t(a) for a in _batch(41, padded=True))
    w = tm.bert.embeddings.word_embeddings.weight
    for p in tm.parameters():
        p.grad = None
    tm.loss(*tm(ids, tt, mask), mlm, nsp.long()).backward()
    both = w.grad.clone()
    w.grad = None
    with torch.no_grad():
        detached = w.detach().clone()
    mlm_logits, nsp_logits = tm(ids, tt, mask)
    seq, _ = tm.bert(ids, tt, mask)
    h = tm.mlm_norm(torch.nn.functional.gelu(tm.mlm_transform(seq)))
    lookup_only = tm.loss(h @ detached.T, nsp_logits, mlm, nsp.long())
    lookup_only.backward()
    lookup = w.grad.clone()
    assert (lookup - both).abs().max() > 0     # the product contributed
    assert lookup.abs().max() > 0              # the lookup contributed


def test_dropout_in_training_raises():
    """BERT at its own dropout 0.1 (hidden and attention) trains, its
    masks and attention-dropout keys drawn from the model's generator:
    two runs from one seed are bitwise equal, another seed differs, the
    losses are finite; eval mode draws nothing. What still raises is a
    probability the flash dropout mode cannot take (1.0: 1 / (1 - p) is
    infinite)."""
    drop = {**TINY, "hidden_dropout_prob": 0.1,
            "attention_probs_dropout_prob": 0.1}
    args, n_inputs = _args(_batch(43, padded=True))

    def run(seed):
        tm = BertForPreTraining(BertConfig(**drop), device="cpu", seed=seed)
        step = TrainStep(tm, AdamW(learning_rate=LR, parameters=tm),
                         _loss_fn(tm), n_inputs=n_inputs)
        return [step(*args).item() for _ in range(3)], export_numpy_state(tm)

    (l1, p1), (l2, p2), (l3, _) = run(5), run(5), run(6)
    assert l1 == l2 and l1 != l3 and np.isfinite(l1).all()
    assert all(np.array_equal(p1[k], p2[k]) for k in p1)
    tm = BertForPreTraining(BertConfig(**drop), device="cpu", seed=5)
    assert all(layer.self_attn.generator is tm.generator
               for layer in tm.bert.encoder.layers)
    ids = torch.zeros((1, 8), dtype=torch.long)
    tm.eval()
    state = tm.generator.get_state()
    mlm, nsp = tm(ids)
    assert torch.equal(tm.generator.get_state(), state)
    assert mlm.shape == (1, 8, TINY["vocab_size"]) and nsp.shape == (1, 2)
    tm = BertForPreTraining(BertConfig(**{
        **drop, "attention_probs_dropout_prob": 1.0}), device="cpu")
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        tm(torch.zeros((1, 256), dtype=torch.long))
