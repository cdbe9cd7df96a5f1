"""The port's ServingEngine against the JAX ServingEngine on
``llama_tiny`` (fp32 weights from the JAX model, the engines' default
bf16 KV pools), driven through the same calls:

- request ``a`` runs alone and finishes; its release caches its pages,
  the last one partial;
- ``b`` is a follow-up turn of ``a`` (its prompt, its reply and three
  new tokens): a prefix hit through the partial page, so a copy-on-write;
- ``c`` and ``d`` are ragged prompts, longer than ``prefill_chunk``, so
  prefills take several chunks; the 14-page pool cannot hold ``b``,
  ``c`` and ``d`` to the end, so the youngest is preempted and
  recomputed.

Greedy streams must be equal at every decisive position (the ROADMAP
rule: a position is decisive when its top-2 logit margin exceeds twice
the logit error between the packages). At the first differing position
of a stream the test computes both packages' logits for that context
and requires the position to be a near-tie; the rest of a diverged
stream is a different context and is not compared.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_tiny
from paddle_tpu.nn.module import functional_call
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny,
                                     load_numpy_state)
from paddle_tpu_torch.serving import SamplingParams, ServingEngine
from torch_one_thread import one_torch_thread  # noqa: F401

ENGINE = dict(num_pages=14, page_size=4, max_slots=3, prefill_chunk=5,
              max_pages_per_slot=12)


@pytest.fixture(scope="module")
def models():
    pt.seed(123)
    jm = JaxLlama(jax_tiny(dtype="float32", mp_axis=None, fsdp_axis=None))
    jm.eval()
    state = {k: np.asarray(v) for k, v in
             jm.state_dict(include_non_persistable_buffer=True).items()}
    tm = LlamaForCausalLM(llama_tiny(), device="cpu", seed=None)
    load_numpy_state(tm, state)
    return jm, tm


def _paged_logits(jm, tm, seq):
    """Last-position logits of ``seq`` from both packages through the
    engines' numeric path: one paged chunk over a fresh bf16 pool."""
    n, ps = len(seq), 4
    pages = -(-n // ps)
    cfg = tm.config
    shape = (pages + 1, ps, cfg.num_key_value_heads, cfg.head_dim)
    tables = np.arange(1, pages + 1, dtype=np.int32)[None]
    ids = np.asarray(seq, np.int32)[None]
    jpools = [(jnp.zeros(shape, jnp.bfloat16), jnp.zeros(shape, jnp.bfloat16))
              for _ in range(cfg.num_hidden_layers)]
    (jl, _), _ = functional_call(
        jm, jm.state_dict(include_non_persistable_buffer=True),
        jnp.asarray(ids), None, jpools, 0,
        (jnp.asarray(tables), jnp.zeros(1, jnp.int32), jnp.ones(1, bool),
         jnp.full(1, n, jnp.int32)), training=False)
    tpools = [(torch.zeros(shape, dtype=torch.bfloat16),
               torch.zeros(shape, dtype=torch.bfloat16))
              for _ in range(cfg.num_hidden_layers)]
    with torch.no_grad():
        tl, _ = tm(torch.tensor(ids), tpools,
                   (torch.tensor(tables), torch.zeros(1, dtype=torch.int32),
                    torch.ones(1, dtype=torch.bool),
                    torch.full((1,), n, dtype=torch.int32)))
    return np.asarray(jl[0, -1]), tl[0, -1].numpy()


def _assert_equal_where_decisive(jm, tm, prompt, want, got):
    for i, (a, b) in enumerate(zip(want, got)):
        if a != b:
            jl, tl = _paged_logits(jm, tm, prompt + want[:i])
            err = float(np.abs(jl - tl).max())
            top2 = np.sort(jl)[-2:]
            assert top2[1] - top2[0] <= 2 * err, (
                f"decisive position {i} differs: jax {a}, port {b}, margin "
                f"{top2[1] - top2[0]}, logit error {err}")
            return
    assert len(want) == len(got)


def _drive(eng, prompts, reply_a=None):
    eng.add_request(prompts["a"], 6, rid="a")
    out = eng.run_to_completion(max_steps=100)
    reply_a = out["a"] if reply_a is None else reply_a
    b = prompts["a"] + reply_a + prompts["b_new"]
    eng.add_request(b, 8, rid="b")
    eng.add_request(prompts["c"], 8, rid="c")
    eng.add_request(prompts["d"], 8, rid="d")
    out = eng.run_to_completion(max_steps=300)
    return out, b


def test_engine_streams_match_jax_engine(models):
    jm, tm = models
    rng = np.random.default_rng(11)
    prompts = {"a": rng.integers(0, 512, 10).tolist(),
               "b_new": rng.integers(0, 512, 3).tolist(),
               "c": rng.integers(0, 512, 13).tolist(),
               "d": rng.integers(0, 512, 7).tolist()}
    jeng = JaxEngine(jm, **ENGINE)
    jout, b_prompt = _drive(jeng, prompts)
    teng = ServingEngine(tm, device="cpu", **ENGINE)
    tout, _ = _drive(teng, prompts, reply_a=jout["a"])
    full = {"a": prompts["a"], "b": b_prompt, "c": prompts["c"],
            "d": prompts["d"]}
    for rid, prompt in full.items():
        _assert_equal_where_decisive(jm, tm, prompt, jout[rid], tout[rid])
        assert len(tout[rid]) == (6 if rid == "a" else 8)
    tm_sum, jm_sum = teng.metrics.summary(), jeng.metrics.summary()
    # the scenario exercised what it is for, in the port ...
    assert tm_sum["preemptions"] >= 1
    assert tm_sum["prefix_hits"] >= 1
    assert tm_sum["prefix_partial_hits"] >= 1
    assert tm_sum["prefix_cow_copies"] >= 1
    assert teng.step_counts["mixed"] >= 3 and teng.step_counts["decode"] >= 1
    # ... and, with equal streams, made the same scheduling decisions
    if tout == jout:
        for key in ("preemptions", "prefix_hits", "prefix_cow_copies",
                    "prefix_evictions", "requests_finished",
                    "tokens_generated", "prefill_cached_tokens"):
            assert tm_sum[key] == jm_sum[key], key
    teng.audit_pool()
    assert all(r.done for r in (teng.request(x) for x in full))


def test_logit_error_between_packages_is_small(models):
    """The decisive-position rule needs a small error to bite: the two
    packages' paged logits agree to a few bf16-pool roundings."""
    jm, tm = models
    seq = np.random.default_rng(3).integers(0, 512, 21).tolist()
    jl, tl = _paged_logits(jm, tm, seq)
    assert float(np.abs(jl - tl).max()) < 2e-3


def test_sampling_and_oversized_requests_rejected(models):
    _, tm = models
    eng = ServingEngine(tm, device="cpu", **ENGINE)
    with pytest.raises(NotImplementedError, match="threefry"):
        eng.add_request([1, 2, 3], 4, sampling=SamplingParams(do_sample=True))
    from paddle_tpu_torch.serving import QueueFullError, RequestTooLargeError
    with pytest.raises(RequestTooLargeError):
        eng.add_request(list(range(60)), 4)     # > max_pages_per_slot
    small = ServingEngine(tm, device="cpu", max_queue_depth=1, **ENGINE)
    small.add_request([1, 2, 3], 2)
    with pytest.raises(QueueFullError):
        small.add_request([4, 5, 6], 2)
    assert small.metrics.summary()["rejected_queue_full"] == 1


def _poison_run(engine_factory, prompts, poison, late_prompt):
    """r0 and r1 decode; r1's last KV page is NaN-poisoned (layer 0, kv
    head 0, every position) when ``poison``; with ``late_prompt`` a
    third request arrives at the same moment, so the next step is a
    mixed step (its prompt chunks) rather than a decode step."""
    eng = engine_factory()
    eng.add_request(prompts[0], 6, rid="r0")
    eng.add_request(prompts[1], 6, rid="r1")
    while not all(eng.request(r).tokens for r in ("r0", "r1")):
        eng.step()
    if late_prompt:
        eng.add_request(prompts[2], 6, rid="r2")
    if poison:
        page = eng.request("r1").pages[-1]
        pk, pv = eng.pool.pools[0]
        if isinstance(pk, torch.Tensor):
            pk[page, :, 0] = float("nan")
        else:
            eng.pool.pools[0] = (pk.at[page, :, 0].set(jnp.nan), pv)
    out = eng.run_to_completion(max_steps=100)
    return eng, out


POISON_ENGINE = dict(num_pages=32, page_size=4, max_slots=3,
                     prefill_chunk=5, max_pages_per_slot=12)


def test_nonfinite_slot_is_quarantined_alone(models):
    """In decode steps a NaN in one request's KV page makes only that
    request's logits non-finite: the per-slot sentinel finishes it with
    "nonfinite", its pages are scrubbed once released, and the other
    stream is that of an unpoisoned run."""
    _, tm = models
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, 512, n).tolist() for n in (9, 6)]

    def factory():
        return ServingEngine(tm, device="cpu", **POISON_ENGINE)
    _, clean = _poison_run(factory, prompts, False, False)
    eng, out = _poison_run(factory, prompts, True, False)
    assert eng.request("r1").finish_reason == "nonfinite"
    assert out["r1"] == clean["r1"][:len(out["r1"])] and len(out["r1"]) < 6
    assert out["r0"] == clean["r0"]
    assert eng.metrics.summary()["quarantined"] == 1
    eng.audit_pool()
    for pk, pv in eng.pool.pools:
        assert bool(torch.isfinite(pk.float()).all())
        assert bool(torch.isfinite(pv.float()).all())


def test_nonfinite_in_mixed_step_matches_jax_engine(models):
    """The same poison when a prompt is chunking: the poisoned slot's
    padded mixed-step rows attend the NaN and write it to scratch page
    0, which every slot's gather reads with weight 0 (0 x NaN = NaN), so
    the JAX engine finishes every request "nonfinite" (ROADMAP C). The
    port reproduces the reference's outcome exactly."""
    jm, tm = models
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, 512, n).tolist() for n in (9, 6, 11)]
    jeng, jout = _poison_run(lambda: JaxEngine(jm, **POISON_ENGINE),
                             prompts, True, True)
    teng, tout = _poison_run(
        lambda: ServingEngine(tm, device="cpu", **POISON_ENGINE),
        prompts, True, True)
    assert tout == jout
    assert ({r: teng.request(r).finish_reason for r in tout}
            == {r: jeng.request(r).finish_reason for r in jout})
    assert teng.request("r1").finish_reason == "nonfinite"
    teng.audit_pool()
