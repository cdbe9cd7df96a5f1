"""The port's paged decode attention (plain version, the CPU path)
against the JAX package.

- against ``paged_attention_tpu``, the Pallas kernel, in interpret mode
  on the CPU, as tests/test_serving.py runs it: fp32 pools, because the
  TPU kernel keeps q and the probabilities in fp32 while the grouped core
  (and the port's CUDA kernel) round them to the cache dtype — at fp32
  the two agree; tolerance 1e-5 (sums in another order);
- against ``paged_attention_decode``'s gather path, ``t == 1`` and
  ``t > 1`` rows, fp32 and bf16 pools: the same arithmetic. Tolerance
  fp32 1e-5; bf16 1e-2 (two bf16 ulps at ``|out| < 2``: q, the
  probabilities and the output are each rounded to bf16, and a rounding
  can flip by one ulp when the fp32 sums before it run in another
  order).

Cases: ragged ``seq_lens`` with page-boundary values (``k*ps - 1``,
``k*ps``), an inactive slot (``seq_lens`` 0, table of scratch page 0),
and g = h / kvh of 1, 2 and 4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn.functional.attention import \
    cached_prefill_attention as jax_cpa
from paddle_tpu.nn.functional.attention import \
    paged_attention_decode as jax_paged
from paddle_tpu.ops.pallas.paged_attention import paged_attention_tpu
from paddle_tpu_torch.nn.functional import (cached_prefill_attention,
                                             paged_attention_decode)
from paddle_tpu_torch.ops.kernels import launch_counts, paged_attention_plain
from torch_one_thread import one_torch_thread  # noqa: F401

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, g, d, ps, t=1, kvh=2, dtype="float32"):
    rng = np.random.default_rng(seed)
    lens = [ps - 1, ps, 2 * ps + 3, None, 3 * ps]      # None: inactive
    b = len(lens)
    M = max(-(-(n + t) // ps) for n in lens if n is not None) + 1
    n_pages = b * M + 1
    perm = rng.permutation(np.arange(1, n_pages))
    tables = np.zeros((b, M), np.int32)
    seq = np.zeros(b, np.int32)
    for s, n in enumerate(lens):
        if n is not None:
            live = -(-(n + t) // ps)
            tables[s, :live] = perm[s * M:s * M + live]
            seq[s] = n

    def rnd(shape):
        a = rng.standard_normal(shape).astype(np.float32)
        return np.asarray(jnp.asarray(a, JDT[dtype]).astype(jnp.float32))
    q = rnd((b, t, g * kvh, d))
    pk, pv = rnd((n_pages, ps, kvh, d)), rnd((n_pages, ps, kvh, d))
    jax_args = (jnp.asarray(q, JDT[dtype]), jnp.asarray(pk, JDT[dtype]),
                jnp.asarray(pv, JDT[dtype]), jnp.asarray(tables),
                jnp.asarray(seq))
    torch_args = (torch.tensor(q).to(TDT[dtype]),
                  torch.tensor(pk).to(TDT[dtype]),
                  torch.tensor(pv).to(TDT[dtype]), torch.tensor(tables),
                  torch.tensor(seq))
    return jax_args, torch_args


@pytest.mark.parametrize("g,d,ps", [(1, 128, 8), (2, 128, 16),
                                    (4, 128, 8), (4, 64, 16)])
def test_plain_decode_matches_pallas_kernel(g, d, ps):
    jax_args, torch_args = _inputs(g * 100 + ps, g, d, ps)
    want = np.asarray(paged_attention_tpu(*jax_args))
    before = launch_counts()
    got = paged_attention_decode(*torch_args)
    assert launch_counts() == before   # a CPU tensor takes the plain path
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [1, 3])
@pytest.mark.parametrize("g", [1, 2, 4])
def test_decode_and_multirow_match_jax_gather_path(g, t, dtype):
    jax_args, torch_args = _inputs(g * 10 + t, g, 64, 8, t=t, dtype=dtype)
    want = np.asarray(jax_paged(*jax_args).astype(jnp.float32))
    got = paged_attention_decode(*torch_args)
    assert got.dtype == TDT[dtype] and got.shape == torch_args[0].shape
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)
    if t == 1:
        torch.testing.assert_close(got, paged_attention_plain(*torch_args),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cached_prefill_attention_matches_jax(dtype):
    """The contiguous-cache twin of the gather path: row j of q sits at
    cache position seq_lens + j and attends up to itself."""
    rng = np.random.default_rng(9)
    q = rng.standard_normal((3, 4, 4, 64)).astype(np.float32)
    kc = rng.standard_normal((3, 24, 2, 64)).astype(np.float32)
    vc = rng.standard_normal((3, 24, 2, 64)).astype(np.float32)
    seq = np.array([0, 7, 19], np.int32)
    j = [jnp.asarray(a, JDT[dtype]) for a in (q, kc, vc)]
    want = np.asarray(jax_cpa(*j, jnp.asarray(seq)).astype(jnp.float32))
    t = [torch.tensor(np.asarray(a.astype(jnp.float32))).to(TDT[dtype])
         for a in j]
    got = cached_prefill_attention(*t, torch.tensor(seq))
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)
