"""The port's KV pool against the JAX package's, driven through the same
operations: allocation, a release into the prefix cache, a prefix match
through a partial page with its copy-on-write, LRU eviction with its
scrub, a token rewind, a quarantine and the audit. Host state (free
list, refcounts, both indexes, LRU order, counters) must be identical
after every operation, and the device pages bitwise equal: the pools
are bf16 in both packages and every device operation copies or zeroes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.serving.kv_cache import KVCachePool as JaxPool
from paddle_tpu_torch.serving import KVCachePool, PoolExhaustedError
from torch_one_thread import one_torch_thread  # noqa: F401

L, P, PS, KVH, D = 2, 9, 4, 2, 8


def _host_state(pool):
    keys = [k for k in KVCachePool(1, 2, PS, 1, 1, device="cpu").counters]
    return (list(pool._free), dict(pool._ref), dict(pool._full_index),
            dict(pool._partial_index), list(pool._lru),
            set(pool._scrub_on_zero), {k: pool.counters[k] for k in keys})


def _check(jp, tp):
    assert _host_state(jp) == _host_state(tp)
    for (jk, jv), (tk, tv) in zip(jp.pools, tp.pools):
        for a, b in ((jk, tk), (jv, tv)):
            np.testing.assert_array_equal(
                np.asarray(a.astype(jnp.float32)), b.float().numpy())


def _write(jp, tp, pages, rng):
    """Fill ``pages`` with the same random (bf16-exact) content."""
    for li in range(L):
        vals = [rng.standard_normal((len(pages), PS, KVH, D))
                .astype(np.float32) for _ in range(2)]
        vals = [np.asarray(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))
                for v in vals]
        idx = jnp.asarray(pages)
        jk, jv = jp.pools[li]
        jp.pools[li] = (jk.at[idx].set(jnp.asarray(vals[0], jnp.bfloat16)),
                        jv.at[idx].set(jnp.asarray(vals[1], jnp.bfloat16)))
        tk, tv = tp.pools[li]
        tk[torch.tensor(pages)] = torch.tensor(vals[0]).bfloat16()
        tv[torch.tensor(pages)] = torch.tensor(vals[1]).bfloat16()


def test_pool_operations_match_jax_pool():
    rng = np.random.default_rng(4)
    jp = JaxPool(L, P, PS, KVH, D)
    tp = KVCachePool(L, P, PS, KVH, D, device="cpu")
    _check(jp, tp)
    toks = rng.integers(0, 512, 30).tolist()
    a = tp.alloc(3)
    assert jp.alloc(3) == a and 0 not in a
    _write(jp, tp, a, rng)
    # a finished request: 2 full pages + a 2-token partial page indexed
    for pool in (jp, tp):
        assert pool.register_prefix(toks[:10], a, include_partial=True) == 3
        pool.release(a)
    _check(jp, tp)
    # a follow-up maps the full pages and COWs the partial one
    jm = jp.match_prefix(toks[:10] + [7, 8], max_tokens=11)
    tm = tp.match_prefix(toks[:10] + [7, 8], max_tokens=11)
    assert (tm.full_pages, tm.partial_page, tm.partial_len,
            tm.cached_tokens) == (jm.full_pages, jm.partial_page,
                                  jm.partial_len, jm.cached_tokens)
    assert tm.cached_tokens == 10 and tm.partial_page == a[2]
    for pool, m in ((jp, jm), (tp, tm)):
        pool.acquire(m.full_pages + [m.partial_page])
        b = pool.alloc(2)
        pool.cow_into(m.partial_page, b[0])
        pool.release([m.partial_page])
        pool.count_match(m)
    _check(jp, tp)
    # exhaustion is all-or-nothing; a big grab evicts the LRU page
    with pytest.raises(PoolExhaustedError):
        tp.alloc(99)
    c = tp.alloc(4)
    assert jp.alloc(4) == c and tp.counters["prefix_evictions"] == 1
    _check(jp, tp)
    # token-granular rollback, then quarantine of a held page
    for pool in (jp, tp):
        pool.rewind(b, 1, 6)
        pool.quarantine(c[:2])
    _check(jp, tp)
    held = [list(a[:2]), list(b), list(c)]
    assert tp.audit(block_tables=held) == jp.audit(block_tables=held)
    for pool in (jp, tp):
        pool.release(c)
    _check(jp, tp)
    assert tp.audit() == jp.audit()
    # the audit catches a lie: a scrubbed free page holding data
    tp.pools[0][0][c[0]] = 1.0
    with pytest.raises(AssertionError, match="nonzero"):
        tp.audit()
