"""The port's Llama against the JAX model on ``llama_tiny``.

- the weight bridge: the JAX ``state_dict`` (numpy) loads unchanged;
  missing, extra and mis-shaped keys raise, naming the key;
- uncached forward logits, fp32, s < 256, tied and untied head.
  Tolerance 1e-4: the same fp32 arithmetic with sums in another order,
  through two layers;
- one paged MIXED step (prefill chunk rows, ``n_live``) and one paged
  DECODE step against JAX's ``functional_call(model, state, ...,
  paged=...)``, with the engine's bf16 pools. Tolerance 2e-3 on the
  logits and one bf16 ulp on the pools: a K/V element whose fp32 value
  differs in its last bits can round to the neighbouring bf16 value.

Weights come from the JAX model, seeded; inputs from numpy, seeded.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_tiny
from paddle_tpu.nn.module import functional_call
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny,
                                     load_numpy_state)
from torch_one_thread import one_torch_thread  # noqa: F401


def _pair(tie=False):
    pt.seed(123)
    jm = JaxLlama(jax_tiny(dtype="float32", mp_axis=None, fsdp_axis=None,
                           tie_word_embeddings=tie))
    jm.eval()
    state = {k: np.asarray(v) for k, v in
             jm.state_dict(include_non_persistable_buffer=True).items()}
    tm = LlamaForCausalLM(llama_tiny(tie_word_embeddings=tie), device="cpu",
                          seed=None)
    load_numpy_state(tm, state)
    return jm, tm, state


@pytest.fixture(scope="module")
def pair():
    return _pair()


def test_weight_bridge_names_and_errors(pair):
    jm, tm, state = pair
    params = dict(tm.named_parameters())
    assert set(params) == set(state) - {"model.rope_cos", "model.rope_sin"}
    for k, v in params.items():
        np.testing.assert_array_equal(v.detach().numpy(), state[k])
    # Paddle layout: Linear weights are [in, out]
    assert tuple(params["model.layers.0.mlp.up_proj.weight"].shape) == \
        (128, 384)
    fresh = LlamaForCausalLM(llama_tiny(), device="cpu", seed=None)
    missing = {k: v for k, v in state.items()
               if k != "model.layers.1.self_attn.k_proj.weight"}
    with pytest.raises(KeyError, match="model.layers.1.self_attn.k_proj"):
        load_numpy_state(fresh, missing)
    with pytest.raises(KeyError, match="model.bogus"):
        load_numpy_state(fresh, {**state, "model.bogus": np.zeros(3)})
    bad = dict(state)
    bad["model.norm.weight"] = np.zeros(127, np.float32)
    with pytest.raises(ValueError, match="model.norm.weight"):
        load_numpy_state(fresh, bad)
    # the rope tables are optional
    no_rope = {k: v for k, v in state.items() if "rope" not in k}
    load_numpy_state(fresh, no_rope)


def test_seeded_random_init_is_reproducible():
    a = LlamaForCausalLM(llama_tiny(), device="cpu", seed=7)
    b = LlamaForCausalLM(llama_tiny(), device="cpu", seed=7)
    for (ka, va), (kb, vb) in zip(a.named_parameters(),
                                  b.named_parameters()):
        assert ka == kb and torch.equal(va, vb)
    assert torch.equal(a.model.norm.weight, torch.ones(128))
    w = a.model.layers[0].mlp.up_proj.weight
    assert abs(w.std().item() - (2.0 / (128 + 384)) ** 0.5) < 5e-3


@pytest.mark.parametrize("tie", [False, True])
def test_uncached_forward_matches_jax(tie):
    jm, tm, _ = _pair(tie)
    ids = np.random.default_rng(1).integers(0, 512, (2, 37)).astype(np.int32)
    want = np.asarray(jm(jnp.asarray(ids)))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    assert got.shape == (2, 37, 512)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _paged_step(jm, tm, state, toks, tables, seq_lens, active, n_live,
                pools):
    """Run one paged step through both packages from the same pools;
    returns (jax logits, jax pools, torch logits, torch pools)."""
    jpools = [(jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16))
              for k, v in pools]
    paged = (jnp.asarray(tables), jnp.asarray(seq_lens), jnp.asarray(active))
    if n_live is not None:
        paged = paged + (jnp.asarray(n_live),)
    (jl, jp), _ = functional_call(jm, state, jnp.asarray(toks), None, jpools,
                                  0, paged, training=False)
    tpools = [(torch.tensor(k).bfloat16(), torch.tensor(v).bfloat16())
              for k, v in pools]
    tpaged = (torch.tensor(tables), torch.tensor(seq_lens),
              torch.tensor(active))
    if n_live is not None:
        tpaged = tpaged + (torch.tensor(n_live),)
    with torch.no_grad():
        tl, tp = tm(torch.tensor(toks), tpools, tpaged)
    return (np.asarray(jl), [(np.asarray(k.astype(jnp.float32)),
                              np.asarray(v.astype(jnp.float32)))
                             for k, v in jp],
            tl.numpy(), [(k.float().numpy(), v.float().numpy())
                         for k, v in tp])


def _assert_pools_close(jp, tp):
    for (jk, jv), (tk, tv) in zip(jp, tp):
        for a, b in ((jk, tk), (jv, tv)):
            np.testing.assert_allclose(b, a, rtol=2 ** -7, atol=1e-6)


def test_paged_mixed_then_decode_step_match_jax(pair):
    jm, tm, _ = pair
    state = jm.state_dict(include_non_persistable_buffer=True)
    rng = np.random.default_rng(2)
    S, K, M, ps, P = 3, 6, 4, 4, 16
    L, kvh, d = 2, 2, 32
    pools = [(np.zeros((P, ps, kvh, d), np.float32),
              np.zeros((P, ps, kvh, d), np.float32)) for _ in range(L)]
    tables = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [0, 0, 0, 0]], np.int32)
    # mixed step: slot 0 a 6-row chunk from 0, slot 1 a 3-row chunk
    # from 0 (rows 3..5 padded), slot 2 inactive
    toks = rng.integers(0, 512, (S, K)).astype(np.int32)
    seq_lens = np.array([0, 0, 0], np.int32)
    active = np.array([True, True, False])
    n_live = np.array([6, 3, 0], np.int32)
    jl, jp, tl, tp = _paged_step(jm, tm, state, toks, tables, seq_lens,
                                 active, n_live, pools)
    np.testing.assert_allclose(tl[:2], jl[:2], rtol=0, atol=2e-3)
    _assert_pools_close(jp, tp)
    # decode step from the JAX pools: one token per slot at seq_lens
    pools = jp
    tok = rng.integers(0, 512, (S, 1)).astype(np.int32)
    seq_lens = np.array([6, 3, 0], np.int32)
    jl, jp, tl, tp = _paged_step(jm, tm, state, tok, tables, seq_lens,
                                 active, None, pools)
    assert tl.shape == (S, 1, 512)
    np.testing.assert_allclose(tl[:2], jl[:2], rtol=0, atol=2e-3)
    _assert_pools_close(jp, tp)


def test_entry_forward_matches_jax_entry(monkeypatch):
    """``__graft_entry__.py::entry()``'s configuration (vocab 8192, hidden
    512, 4 layers, 8 / 4 heads of 64, fp32: ``LlamaConfig``'s default
    dtype) at its [2, 256] ids through the port, from the weights of the
    model ``entry()`` builds, against ``entry()``'s own jitted forward.
    The JAX flash route is switched on (``_flash_backend_ok``, as on its
    TPU), so at s 256 both take flash attention: the Pallas kernel in
    interpret mode and the port's plain version (on the card, its fp32
    kernel). Tolerance: fp32, 2e-5 relative and 1e-4 absolute on logits
    of magnitude ~1-10 (the same fp32 arithmetic, sums in another order,
    through four layers)."""
    import __graft_entry__ as G
    from paddle_tpu.nn.functional import attention as jattn
    from paddle_tpu_torch.models import LlamaConfig
    monkeypatch.setattr(jattn, "_flash_backend_ok", lambda: True)
    fn, (ids,) = G.entry()
    state = next(c.cell_contents for c in fn.__closure__
                 if isinstance(c.cell_contents, dict))
    want = np.asarray(fn(ids))
    cfg = LlamaConfig(vocab_size=8192, hidden_size=512,
                      intermediate_size=1408, num_hidden_layers=4,
                      num_attention_heads=8, num_key_value_heads=4,
                      max_position_embeddings=2048, mp_axis=None,
                      fsdp_axis=None)
    assert cfg.dtype == "float32"
    tm = LlamaForCausalLM(cfg, device="cpu", seed=None)
    load_numpy_state(tm, {k: np.asarray(v) for k, v in state.items()})
    tm.eval()
    with torch.no_grad():
        got = tm(torch.tensor(np.asarray(ids)))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-4)
