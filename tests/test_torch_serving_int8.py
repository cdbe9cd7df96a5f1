"""The port's int8 serving path against the JAX package's, on the CPU.

- ``kv_quantize`` and ``quantize_weight``: codes and scales bitwise equal
  to JAX (per channel, per group, zero rows and columns);
  ``kv_dequantize`` and ``Int8ServingLinear`` to 1e-5 (fp32: the same
  products, sums in another order);
- ``quantize_for_serving`` swaps the same layers and keeps ``lm_head``;
  a JAX-quantized state and the port quantizing its own loaded weights
  give bitwise-equal buffers;
- the quantized pool: layout, bytes per token, the hash root of each
  format, and COW, scrub, rewind, eviction and quarantine on codes and
  scales, bitwise against the JAX pool;
- the int8 paged attention (plain version) against the Pallas kernel's
  int8 mode in interpret mode and against the JAX gather path, 2e-6
  (fp32 q, the tolerance of the JAX package's own
  ``test_kernel_int8_matches_xla_gather_path``);
- the slice: the port's ``ServingEngine(kv_quant=True)`` against the JAX
  int8 engine on the scenario of ``test_torch_serving.py`` (multi-chunk
  prefills, a partial-page prefix hit with COW, a preemption), with int8
  KV alone and with int8 KV and int8 weights: equal greedy streams and
  equal scheduling counts; and a NaN written into one page's scale rows
  gives the JAX engine's outcome.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn.functional.attention import \
    paged_attention_decode as jax_paged
from paddle_tpu.ops.pallas.paged_attention import paged_attention_tpu
from paddle_tpu.quantization import Int8ServingLinear as JaxInt8Linear
from paddle_tpu.quantization import QuantizedKV as JaxQKV
from paddle_tpu.quantization import kv_dequantize as jax_kv_dequantize
from paddle_tpu.quantization import kv_quantize as jax_kv_quantize
from paddle_tpu.quantization import quantize_for_serving as jax_qfs
from paddle_tpu.quantization import quantize_weight as jax_quantize_weight
from paddle_tpu.quantization import serving_state_bytes as jax_state_bytes
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving.kv_cache import _HASH_ROOT_INT8
from paddle_tpu.serving.kv_cache import KVCachePool as JaxPool
from paddle_tpu_torch.models import (LlamaForCausalLM, export_numpy_state,
                                     llama_tiny, load_numpy_state)
from paddle_tpu_torch.nn.functional import paged_attention_decode
from paddle_tpu_torch.nn.layer import Linear
from paddle_tpu_torch.ops.kernels import launch_counts, paged_attention_plain
from paddle_tpu_torch.quantization import (Int8ServingLinear, QuantizedKV,
                                           kv_dequantize, kv_quantize,
                                           quantize_for_serving,
                                           quantize_weight,
                                           serving_state_bytes)
from paddle_tpu_torch.serving import KVCachePool, ServingEngine
from paddle_tpu_torch.serving import kv_cache as port_kv_cache
from test_torch_paged_attention import _inputs
from test_torch_serving import ENGINE, POISON_ENGINE, _drive
from torch_one_thread import one_torch_thread  # noqa: F401


def _np(a):
    return np.asarray(a)


def _rows(seed, shape, zero_rows=()):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x *= np.float32(3.0)
    for r in zero_rows:
        x[r] = 0.0
    return x


# ---------------- quantizers ----------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_quantize_is_bitwise_jax(dtype):
    x = _rows(1, (6, 5, 3, 32), zero_rows=[(2, 1), (4, 0, 2)])
    jx = jnp.asarray(x, jnp.float32 if dtype == "float32" else jnp.bfloat16)
    want = jax_kv_quantize(jx)
    got = kv_quantize(torch.tensor(_np(jx.astype(jnp.float32))).to(
        getattr(torch, dtype)))
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), _np(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), _np(want.scale))
    assert not got.q[2, 1].any() and not got.scale[2, 1].any()
    deq = kv_dequantize(got)
    np.testing.assert_allclose(deq.numpy(), _np(jax_kv_dequantize(want)),
                               rtol=1e-5, atol=1e-5)
    assert float((deq - torch.tensor(_np(jx.astype(jnp.float32)))).abs()
                 .max()) <= float(got.scale.max()) / 2 * (1 + 1e-6)


@pytest.mark.parametrize("group_size", [None, 32, 64])
def test_quantize_weight_is_bitwise_jax(group_size):
    w = _rows(2, (128, 48))
    w[:, 5] = 0.0                       # a zero channel
    w[32:64, 7] = 0.0                   # a zero group
    jq, js = jax_quantize_weight(jnp.asarray(w), 8, group_size)
    tq, ts = quantize_weight(torch.tensor(w), 8, group_size)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), _np(jq))
    np.testing.assert_array_equal(ts.numpy(), _np(js))
    with pytest.raises(ValueError, match="does not divide"):
        quantize_weight(torch.tensor(w), 8, 48)
    with pytest.raises(ValueError, match="at most 8 bits"):
        quantize_weight(torch.tensor(w), 16)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2 ** -7)])
@pytest.mark.parametrize("group_size", [None, 32])
def test_int8_linear_matches_jax_layer(group_size, dtype, tol):
    """fp32: 1e-5. bf16 x: both round the same fp32 value once, which
    can differ in its last bits by summation order: one bf16 ulp."""
    w = _rows(3, (64, 40))
    x = _rows(4, (2, 3, 64))
    jq, js = jax_quantize_weight(jnp.asarray(w), 8, group_size)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jx = jnp.asarray(x, jdt)
    want = _np(JaxInt8Linear(jq, js)(jx).astype(jnp.float32))
    layer = Int8ServingLinear(*quantize_weight(torch.tensor(w), 8,
                                               group_size))
    got = layer(torch.tensor(_np(jx.astype(jnp.float32))).to(
        getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 3, 40)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol)


# ---------------- the quantized model and its state ----------------

@pytest.fixture(scope="module")
def models():
    import paddle_tpu as pt
    from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
    from paddle_tpu.models.llama import llama_tiny as jax_tiny
    pt.seed(123)
    jm = JaxLlama(jax_tiny(dtype="float32", mp_axis=None, fsdp_axis=None))
    jm.eval()
    tm = LlamaForCausalLM(llama_tiny(), device="cpu", seed=None)
    load_numpy_state(tm, _jax_state(jm))
    return jm, tm


def _jax_state(m):
    return {k: _np(v) for k, v in
            m.state_dict(include_non_persistable_buffer=True).items()}


def test_quantize_for_serving_swaps_the_jax_layers(models):
    jm, tm = models
    jq, tq = jax_qfs(jm), quantize_for_serving(tm)
    jkeys = sorted(k for k in _jax_state(jq) if "rope" not in k)
    assert sorted(tq.state_dict()) == jkeys
    L = tm.config.num_hidden_layers
    assert sum(k.endswith(".weight_q") for k in jkeys) == 7 * L
    assert "lm_head.weight" in jkeys and not tq.training
    assert isinstance(tm.lm_head, Linear)                  # a copy
    assert isinstance(tm.model.layers[0].mlp.up_proj, Linear)
    assert serving_state_bytes(tq) == jax_state_bytes(jq)
    assert serving_state_bytes(tm) == jax_state_bytes(jm)
    same = quantize_for_serving(tq, inplace=True)
    assert same is tq


def test_quantized_state_is_bitwise_by_both_routes(models):
    """A JAX ``quantize_for_serving`` state loaded into a port-quantized
    model, and the port quantizing the same fp weights itself, give the
    same buffers bit for bit; loading neither casts the int8 codes nor
    the fp32 scales, not even into a bf16 model."""
    jm, tm = models
    jstate = _jax_state(jax_qfs(jm))
    by_port = export_numpy_state(quantize_for_serving(tm))
    skeleton = quantize_for_serving(
        LlamaForCausalLM(llama_tiny(), device="cpu", seed=7))
    load_numpy_state(skeleton, jstate)
    by_jax = export_numpy_state(skeleton)
    assert sorted(by_port) == sorted(by_jax)
    for k, a in by_port.items():
        assert a.dtype == by_jax[k].dtype, k
        np.testing.assert_array_equal(a, by_jax[k], err_msg=k)
        if k.endswith(".weight_q"):
            assert a.dtype == np.int8
            np.testing.assert_array_equal(a, jstate[k], err_msg=k)
        if k.endswith(".weight_scale"):
            assert a.dtype == np.float32
    bf16 = quantize_for_serving(LlamaForCausalLM(
        llama_tiny(dtype="bfloat16"), device="cpu", seed=7))
    load_numpy_state(bf16, jstate)
    layer = bf16.model.layers[1].self_attn.k_proj
    assert layer.weight_q.dtype == torch.int8
    assert layer.weight_scale.dtype == torch.float32
    np.testing.assert_array_equal(
        layer.weight_scale.numpy(),
        jstate["model.layers.1.self_attn.k_proj.weight_scale"])
    key = "model.layers.0.mlp.down_proj.weight_q"
    with pytest.raises(ValueError, match="dtype mismatch"):
        load_numpy_state(skeleton, {**jstate,
                                    key: jstate[key].astype(np.float32)})


# ---------------- the quantized pool ----------------

L, P, PS, KVH, D = 2, 9, 4, 2, 8


def _host_state(pool):
    return (list(pool._free), dict(pool._ref), dict(pool._full_index),
            dict(pool._partial_index), list(pool._lru),
            set(pool._scrub_on_zero), dict(pool.counters))


def _check(jp, tp):
    assert _host_state(jp) == _host_state(tp)
    for jpair, tpair in zip(jp.pools, tp.pools):
        for ja, ta in zip(jpair, tpair):
            np.testing.assert_array_equal(_np(ja.q), ta.q.numpy())
            np.testing.assert_array_equal(_np(ja.scale), ta.scale.numpy())


def _write(jp, tp, pages, rng):
    idx = jnp.asarray(pages)
    for li in range(L):
        pair_j, pair_t = [], []
        for ja, ta in zip(jp.pools[li], tp.pools[li]):
            c = jax_kv_quantize(jnp.asarray(rng.standard_normal(
                (len(pages), PS, KVH, D)).astype(np.float32)))
            pair_j.append(JaxQKV(ja.q.at[idx].set(c.q),
                                 ja.scale.at[idx].set(c.scale)))
            ta.q[torch.tensor(pages)] = torch.tensor(_np(c.q))
            ta.scale[torch.tensor(pages)] = torch.tensor(_np(c.scale))
        jp.pools[li] = tuple(pair_j)


def test_quantized_pool_matches_jax_pool():
    rng = np.random.default_rng(4)
    jp = JaxPool(L, P, PS, KVH, D, quantized=True)
    tp = KVCachePool(L, P, PS, KVH, D, device="cpu", quantized=True)
    pk, pv = tp.pools[0]
    assert isinstance(pk, QuantizedKV) and tp.dtype == torch.int8
    assert pk.q.shape == (P, PS, KVH, D) and pk.scale.shape == (P, PS, KVH)
    assert pk.q.dtype == torch.int8 and pv.scale.dtype == torch.float32
    assert tp.kv_bytes_per_token() == jp.kv_bytes_per_token()
    assert KVCachePool(L, P, PS, KVH, D, device="cpu").kv_bytes_per_token() \
        == JaxPool(L, P, PS, KVH, D).kv_bytes_per_token()
    assert tp.stats()["kv_quant"] == jp.stats()["kv_quant"] == 1
    # the int8 format chains its page hashes from its own root
    assert port_kv_cache._HASH_ROOT_INT8 == _HASH_ROOT_INT8
    assert tp._hash_root == _HASH_ROOT_INT8 != port_kv_cache._HASH_ROOT
    _check(jp, tp)
    toks = rng.integers(0, 512, 30).tolist()
    a = tp.alloc(3)
    assert jp.alloc(3) == a
    _write(jp, tp, a, rng)
    for pool in (jp, tp):
        assert pool.register_prefix(toks[:10], a, include_partial=True) == 3
        pool.release(a)
    _check(jp, tp)     # equal index keys: the same root, the same chain
    fp = KVCachePool(L, P, PS, KVH, D, device="cpu")
    fp.register_prefix(toks[:10], fp.alloc(3), include_partial=True)
    assert not set(fp._full_index) & set(tp._full_index)
    m = {}
    for name, pool in (("j", jp), ("t", tp)):
        m[name] = pool.match_prefix(toks[:10] + [7, 8], max_tokens=11)
        pool.acquire(m[name].full_pages + [m[name].partial_page])
        b = pool.alloc(2)
        pool.cow_into(m[name].partial_page, b[0])     # codes and scales
        pool.release([m[name].partial_page])
    assert m["t"].cached_tokens == m["j"].cached_tokens == 10
    _check(jp, tp)
    c = tp.alloc(4)
    assert jp.alloc(4) == c and tp.counters["prefix_evictions"] == 1
    _check(jp, tp)     # the evicted page's codes and scales are zero
    for pool in (jp, tp):
        pool.rewind(b, 1, 6)
        pool.quarantine(c[:2])
        pool.release(c)
    _check(jp, tp)
    assert tp.audit() == jp.audit()
    tp.pools[1][1].scale[c[0], 0, 0] = float("nan")   # a poisoned scale
    with pytest.raises(AssertionError, match="nonzero"):
        tp.audit()
    tp.scrub([c[0]])
    tp.audit()


# ---------------- int8 paged attention ----------------

def _quantized(jax_args, torch_args):
    q, pk, pv, tables, seq = jax_args
    jk, jv = jax_kv_quantize(pk), jax_kv_quantize(pv)
    tk = QuantizedKV(*(torch.tensor(_np(a)) for a in jk))
    tv = QuantizedKV(*(torch.tensor(_np(a)) for a in jv))
    return ((q, jk, jv, tables, seq),
            (torch_args[0], tk, tv, torch_args[3], torch_args[4]))


@pytest.mark.parametrize("g,d,ps", [(1, 128, 8), (2, 128, 16),
                                    (4, 64, 16)])
def test_plain_int8_decode_matches_pallas_kernel(g, d, ps):
    jax_args, torch_args = _quantized(*_inputs(g * 7 + ps, g, d, ps))
    q, jk, jv, tables, seq = jax_args
    want = _np(paged_attention_tpu(q, jk.q, jv.q, tables, seq,
                                   k_scale=jk.scale, v_scale=jv.scale))
    before = launch_counts()
    got = paged_attention_decode(*torch_args)
    assert launch_counts() == before   # a CPU tensor takes the plain path
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("t", [1, 3])
@pytest.mark.parametrize("g", [1, 2, 4])
def test_int8_decode_and_multirow_match_jax_gather_path(g, t):
    jax_args, torch_args = _quantized(*_inputs(g * 11 + t, g, 64, 8, t=t))
    want = _np(jax_paged(*jax_args))
    got = paged_attention_decode(*torch_args)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=2e-6)
    q, tk, tv, tables, seq = torch_args
    if t == 1:
        torch.testing.assert_close(
            got, paged_attention_plain(q, tk.q, tv.q, tables, seq,
                                       k_scale=tk.scale, v_scale=tv.scale),
            rtol=0, atol=0)


# ---------------- the slice ----------------

@pytest.mark.parametrize("int8_weights", [False, True],
                         ids=["int8_kv", "int8_kv_and_weights"])
def test_int8_engine_streams_match_jax_int8_engine(models, int8_weights):
    jm, tm = models
    if int8_weights:
        jm, tm = jax_qfs(jm), quantize_for_serving(tm)
    rng = np.random.default_rng(11)
    prompts = {"a": rng.integers(0, 512, 10).tolist(),
               "b_new": rng.integers(0, 512, 3).tolist(),
               "c": rng.integers(0, 512, 13).tolist(),
               "d": rng.integers(0, 512, 7).tolist()}
    jeng = JaxEngine(jm, kv_quant=True, **ENGINE)
    jout, _ = _drive(jeng, prompts)
    teng = ServingEngine(tm, device="cpu", kv_quant=True, **ENGINE)
    tout, _ = _drive(teng, prompts, reply_a=jout["a"])
    assert tout == jout
    tsum, jsum = teng.metrics.summary(), jeng.metrics.summary()
    assert tsum["preemptions"] >= 1 and tsum["prefix_cow_copies"] >= 1
    assert tsum["prefix_partial_hits"] >= 1
    assert teng.step_counts["mixed"] >= 3 and teng.step_counts["decode"] >= 1
    for key in ("preemptions", "prefix_hits", "prefix_cow_copies",
                "prefix_evictions", "requests_finished", "tokens_generated",
                "prefill_cached_tokens", "kv_quant_enabled"):
        assert tsum[key] == jsum[key], key
    assert tsum["kv_quant_enabled"] == 1
    np.testing.assert_allclose(tsum["kv_quant_scale_max"],
                               jsum["kv_quant_scale_max"], rtol=1e-5)
    assert tsum["kv_quant_err_bound"] == tsum["kv_quant_scale_max"] / 2
    assert teng.stats()["kv_quant"] and teng.stats()["pool"]["kv_quant"]
    teng.audit_pool()


def test_kv_dtype_int8_is_an_alias(models):
    _, tm = models
    eng = ServingEngine(tm, device="cpu", kv_dtype="int8", **ENGINE)
    assert eng.kv_quant and eng.pool.quantized
    assert ServingEngine(tm, device="cpu", kv_dtype=torch.int8,
                         **ENGINE).kv_quant
    assert not ServingEngine(tm, device="cpu", kv_dtype="bfloat16",
                             **ENGINE).kv_quant
    with pytest.raises(ValueError, match="kv_dtype"):
        ServingEngine(tm, device="cpu", kv_dtype="float16", **ENGINE)


def _poison_scale_run(engine_factory, prompts, late_prompt):
    """As ``test_torch_serving._poison_run``, with the NaN in the scale
    rows of r1's last page (layer 0, K, kv head 0): int8 codes cannot
    hold a NaN, so the JAX engine poisons the scale (engine.py:1434)."""
    eng = engine_factory()
    eng.add_request(prompts[0], 6, rid="r0")
    eng.add_request(prompts[1], 6, rid="r1")
    while not all(eng.request(r).tokens for r in ("r0", "r1")):
        eng.step()
    if late_prompt:
        eng.add_request(prompts[2], 6, rid="r2")
    page = eng.request("r1").pages[-1]
    pk, pv = eng.pool.pools[0]
    if isinstance(pk, QuantizedKV):
        pk.scale[page, :, 0] = float("nan")
    else:
        eng.pool.pools[0] = (
            JaxQKV(pk.q, pk.scale.at[page, :, 0].set(jnp.nan)), pv)
    return eng, eng.run_to_completion(max_steps=100)


@pytest.mark.parametrize("late_prompt", [False, True],
                         ids=["decode_steps", "mixed_step"])
def test_nan_scale_quarantine_matches_jax_engine(models, late_prompt):
    """Decode steps: only r1 reads the NaN and finishes "nonfinite"; its
    pages are scrubbed, codes and scales, once released. With a prompt
    chunking in the same step the padded rows carry the NaN to scratch
    page 0 as in the bf16 pool (ROADMAP C), so the outcome is the JAX
    int8 engine's, whatever it is."""
    jm, tm = models
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, 512, n).tolist() for n in (9, 6, 11)]
    jeng, jout = _poison_scale_run(
        lambda: JaxEngine(jm, kv_quant=True, **POISON_ENGINE), prompts,
        late_prompt)
    teng, tout = _poison_scale_run(
        lambda: ServingEngine(tm, device="cpu", kv_quant=True,
                              **POISON_ENGINE), prompts, late_prompt)
    assert tout == jout
    assert ({r: teng.request(r).finish_reason for r in tout}
            == {r: jeng.request(r).finish_reason for r in jout})
    assert teng.request("r1").finish_reason == "nonfinite"
    assert len(tout["r1"]) < 6
    if not late_prompt:
        assert teng.request("r0").finish_reason == "length"
        assert teng.metrics.summary()["quarantined"] == 1
        for pair in teng.pool.pools:
            for arr in pair:
                assert bool(torch.isfinite(arr.scale).all())
    teng.audit_pool()
