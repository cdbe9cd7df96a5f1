"""The port's top-2 MoE routing against the JAX package, on the CPU.

- the plain version of the routing kernel (``routing_plain``) against
  the JAX kernel's ``_run_kernel`` (Pallas, interpret mode) on the same
  logits and uniforms: all nine outputs, ties included;
- ``_top2_parts`` of both packages, the fused route (the kernel's plain
  version plus the epilogue here, the Pallas kernel there) and the plain
  chain, with the same uniforms: T 1024 with E 16 and E 8, the random
  and the keep-all policies, and a tight capacity of 8;
- the logits' gradient of ``w1``, ``w2`` and aux through both routes.

Tolerances: integer outputs equal; ``w1``, ``w2`` and aux ``rtol 1e-5,
atol 1e-6`` (fp32, the same arithmetic with sums in another order);
the gradient ``rtol 1e-4, atol 1e-6``, the tolerance of
``tests/test_moe_ragged.py::TestFusedRouting::test_gradients_match_xla_chain``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.distributed.moe import _top2_parts as jax_top2_parts
from paddle_tpu.ops.pallas import moe_routing as jax_routing
from paddle_tpu_torch.distributed.moe import _top2_parts
from paddle_tpu_torch.ops.kernels import launch_counts
from paddle_tpu_torch.ops.kernels.moe_routing import (
    fused_routing_applicable, moe_routing_cuda, routing_plain)
from torch_one_thread import one_torch_thread  # noqa: F401

NAMES = ("g1_idx", "g2_idx", "w1", "w2", "keep1", "keep2f", "p1", "p2",
         "aux")
KERNEL_OUT = ("g1i", "g2i", "g1", "g2", "p1", "c2", "keep2", "count1",
              "me_sum")


def _inputs(T, E, seed, scale=2.0):
    r = np.random.default_rng(seed)
    logits = (r.standard_normal((T, E)) * scale).astype(np.float32)
    key = jax.random.key(seed + 7)
    u = np.asarray(jax.random.uniform(key, (T,)))
    return logits, key, u


def _assert_same(got, want, names):
    for name, a, b in zip(names, got, want):
        a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
        b = np.asarray(b)
        if b.dtype.kind in "ib":
            np.testing.assert_array_equal(a.astype(np.int64),
                                          b.astype(np.int64), err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6,
                                       err_msg=name)


@pytest.mark.parametrize("random_keep2", [True, False])
@pytest.mark.parametrize("E", [16, 8])
def test_kernel_plain_version_matches_pallas_kernel(E, random_keep2):
    logits, _, u = _inputs(2048, E, E)
    logits[5] = logits[6] = 0.0          # fully tied rows: first index wins
    logits[9, :3] = logits[9].max() + 1.0  # a tie for the top expert
    want = jax_routing._run_kernel(jnp.asarray(logits), jnp.asarray(u),
                                   random_keep2)
    got = routing_plain(torch.tensor(logits), torch.tensor(u), random_keep2)
    _assert_same(got, want, KERNEL_OUT)
    assert int(got[1][5]) == 1 and int(got[0][9]) == 0


@pytest.mark.parametrize("policy", ["random", "all"])
@pytest.mark.parametrize("E", [16, 8])
def test_top2_parts_match_jax(E, policy):
    T = 1024
    logits, key, u = _inputs(T, E, 0)
    cap = int(1.25 * T * 2 / E)
    assert fused_routing_applicable(T, E)
    want_fused = jax_top2_parts(jnp.asarray(logits), cap,
                                second_policy=policy, key=key, impl="fused")
    want_xla = jax_top2_parts(jnp.asarray(logits), cap,
                              second_policy=policy, key=key)
    ut = torch.tensor(u) if policy == "random" else None
    for impl, want in (("fused", want_fused), ("xla", want_xla)):
        got = _top2_parts(torch.tensor(logits), cap, second_policy=policy,
                          u=ut, impl=impl)
        _assert_same(got, want, NAMES)


def test_tight_capacity_drops_match():
    T, E = 1024, 16
    logits, key, u = _inputs(T, E, 3)
    want = jax_top2_parts(jnp.asarray(logits), 8, second_policy="random",
                          key=key, impl="fused")
    before = launch_counts()
    got = _top2_parts(torch.tensor(logits), 8, second_policy="random",
                      u=torch.tensor(u), impl="fused")
    assert launch_counts() == before      # a CPU tensor launches nothing
    assert int((~got[4]).sum()) > 0 and int((~got[5]).sum()) > 0
    _assert_same(got, want, NAMES)


@pytest.mark.parametrize("impl", ["fused", "xla"])
def test_gradients_match_jax(impl):
    r = np.random.default_rng(1)
    T, E, cap = 1024, 8, 320
    logits = r.standard_normal((T, E)).astype(np.float32)
    key = jax.random.key(3)
    u = np.asarray(jax.random.uniform(key, (T,)))
    cw1 = r.standard_normal(T).astype(np.float32)
    cw2 = r.standard_normal(T).astype(np.float32)

    def jloss(lg):
        out = jax_top2_parts(lg, cap, second_policy="random", key=key,
                             impl=impl)
        return jnp.sum(out[2] * cw1) + jnp.sum(out[3] * cw2) + 3.0 * out[8]

    want = jax.grad(jloss)(jnp.asarray(logits))
    lt = torch.tensor(logits).requires_grad_(True)
    out = _top2_parts(lt, cap, second_policy="random", u=torch.tensor(u),
                      impl=impl)
    ((out[2] * torch.tensor(cw1)).sum() + (out[3] * torch.tensor(cw2)).sum()
     + 3.0 * out[8]).backward()
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-6)


def test_kernel_wrapper_raises_on_a_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA"):
        moe_routing_cuda(torch.zeros((1024, 16)), None, False)
    assert not fused_routing_applicable(1000, 16)
    assert not fused_routing_applicable(1024, 129)
