"""The port's fused grouped-GEMM MoE dispatch against the JAX package, on
the CPU.

The JAX side runs its Pallas kernels in interpret mode; the port runs
the kernels' plain versions (a CPU tensor never reaches a kernel). Same
routing (the JAX ``_top2_parts``, keep-all policy) and the same slot
maps feed both:

- ``fused_grouped_moe``'s forward and VJP (dx, d gate_w, dW in, gate and
  out) at the JAX tests' shapes (T 256, D 128, E 4, H 64 and 96), fp32
  and bf16, a capacity-overflow case, and the ungated ``relu`` FFN;
- ``slot_maps`` of both packages;
- ``moe_fused_compute`` and ``moe_grouped_compute`` of both packages,
  forward and the gradients of x, the combine weights and the experts.

Tolerances are those of ``tests/test_moe_fused_dispatch.py``: fp32
``rtol 1e-4, atol 1e-5`` (fp32 sums in another order); bf16 forward
``rtol 3e-2, atol 3e-3`` and gradients ``rtol 5e-2, atol 5e-2`` (an
fp32 sum in another order can move a bf16 rounding of h, dy, dh1 or dhg
by one ulp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.nn.functional as JF
from paddle_tpu.distributed import moe as jax_moe
from paddle_tpu.ops.pallas import moe_grouped_gemm as jax_gg
from paddle_tpu_torch.distributed import moe
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.kernels import launch_counts
from paddle_tpu_torch.ops.kernels import moe_grouped_gemm as gg
from torch_one_thread import one_torch_thread  # noqa: F401

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
T, D, E = 256, 128, 4


def _tol(dtype, grad=False):
    if dtype == "float32":
        return dict(rtol=1e-4, atol=1e-5)
    return dict(rtol=5e-2, atol=5e-2) if grad else dict(rtol=3e-2,
                                                        atol=3e-3)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _route(capfac, seed):
    r = np.random.default_rng(seed)
    logits = jnp.asarray(r.standard_normal((T, E)) * 1.5, jnp.float32)
    cap = max(4, int(capfac * T * 2 / E))
    g1, g2, w1, w2, k1, k2, p1, p2, _ = jax_moe._top2_parts(
        logits, cap, second_policy="all")
    return (np.stack([g1, g2], 1), np.stack([w1, w2], 1),
            np.stack([p1, p2], 1), np.stack([k1, k2], 1), cap)


def _problem(H, dtype, capfac, seed, gated=True):
    """Routing, inputs and weights as numpy (values exact in dtype)."""
    idx, w, pos, keep, cap = _route(capfac, seed)
    r = np.random.default_rng(seed + 100)

    def mk(*shape, s=1.0):
        a = jnp.asarray(r.standard_normal(shape) * s, JDT[dtype])
        return np.asarray(a.astype(jnp.float32))

    ws = (mk(E, D, H, s=0.05), mk(E, D, H, s=0.05) if gated else None,
          mk(E, H, D, s=0.05))
    return idx, w, pos, keep, cap, mk(T, D), mk(T, D), ws


def _j(a, dtype):
    return None if a is None else jnp.asarray(a, JDT[dtype])


def _t(a, dtype, grad=False):
    if a is None:
        return None
    t = torch.tensor(a).to(TDT[dtype])
    return t.requires_grad_(True) if grad else t


def _jax_maps(idx, pos, keep, cap, w):
    cpad = jax_gg.padded_capacity(cap)
    slot, _, fill, occ = jax_moe._slot_structures(
        jnp.asarray(idx), jnp.asarray(pos), jnp.asarray(keep), E, cpad)
    return jax_gg.slot_maps(slot, fill, occ, jnp.asarray(w).reshape(-1), T,
                            E, cpad, 2)


CASES = [("float32", 64, 1.25, True), ("float32", 96, 1.0, True),
         ("bfloat16", 64, 1.25, True), ("bfloat16", 96, 1.25, True),
         ("float32", 64, 0.3, True), ("float32", 64, 1.25, False)]


@pytest.mark.parametrize("dtype,H,capfac,gated", CASES)
def test_fused_grouped_moe_forward_and_vjp_match_jax(dtype, H, capfac,
                                                     gated):
    act = "silu" if gated else "relu"
    idx, w, pos, keep, cap, x, ct, (wi, wg, wo) = _problem(
        H, dtype, capfac, seed=H + int(capfac * 10), gated=gated)
    if capfac < 1:
        assert not keep.all()             # copies are dropped
    row_id, gate_w = _jax_maps(idx, pos, keep, cap, w)
    jargs = [_j(x, dtype), row_id, gate_w, _j(wi, dtype), _j(wg, dtype),
             _j(wo, dtype)]

    def jfn(x_, gw_, a, c, *b):
        return jax_gg.fused_grouped_moe(x_, row_id, gw_, a,
                                        b[0] if b else None, c, act)

    jin = [jargs[0], gate_w, jargs[3], jargs[5]] + ([jargs[4]] if gated
                                                     else [])
    jout, vjp = jax.vjp(jfn, *jin)
    jgrads = vjp(_j(ct, dtype))
    tx = _t(x, dtype, True)
    tgw = torch.tensor(np.asarray(gate_w)).requires_grad_(True)
    twi, twg, two = (_t(a, dtype, True) for a in (wi, wg, wo))
    trow = torch.tensor(np.asarray(row_id))
    np.testing.assert_array_equal(
        gg.slot_maps(*_port_slot(idx, pos, keep, cap), torch.tensor(
            w).reshape(-1), T, E, gg.padded_capacity(cap), 2)[0].numpy(),
        np.asarray(row_id))
    before = launch_counts()
    out = gg.fused_grouped_moe(tx, trow, tgw, twi, twg, two, act)
    out.backward(_t(ct, dtype))
    assert launch_counts() == before
    assert out.dtype == TDT[dtype]
    np.testing.assert_allclose(_f32(out), _f32(jout), **_tol(dtype))
    got = [tx.grad, tgw.grad, twi.grad, two.grad] + ([twg.grad] if gated
                                                     else [])
    for name, a, b in zip(("dx", "dgate_w", "dw_in", "dw_out", "dw_gate"),
                          got, jgrads):
        assert a.dtype == (torch.float32 if name == "dgate_w"
                           else TDT[dtype]), name
        np.testing.assert_allclose(_f32(a), _f32(b), err_msg=name,
                                   **_tol(dtype, grad=True))


def _port_slot(idx, pos, keep, cap):
    slot, _, fill, occ = moe._slot_structures(
        torch.tensor(idx).long(), torch.tensor(pos).long(),
        torch.tensor(keep), E, gg.padded_capacity(cap))
    return slot, fill, occ


@pytest.mark.parametrize("path", ["fused", "grouped"])
@pytest.mark.parametrize("capfac", [1.25, 0.3])
def test_moe_compute_matches_jax(path, capfac):
    """``moe_{fused,grouped}_compute`` end to end in fp32: the output and
    the gradients of x, the combine weights and the three experts."""
    H = 64
    idx, w, pos, keep, cap, x, ct, (wi, wg, wo) = _problem(
        H, "float32", capfac, seed=7)
    assert jax_gg.fused_dispatch_applicable(T, D, H, E, cap, jnp.float32,
                                            JF.silu, True)
    jfn = {"fused": jax_moe.moe_fused_compute,
           "grouped": jax_moe.moe_grouped_compute}[path]
    tfn = {"fused": moe.moe_fused_compute,
           "grouped": moe.moe_grouped_compute}[path]
    jidx, jpos, jkeep = (jnp.asarray(a) for a in (idx, pos, keep))

    def jloss(x_, w_, a, b, c):
        return jnp.sum(jfn(x_, jidx, w_, jpos, jkeep, cap, a, b, c,
                           JF.silu) * ct)

    jval = jfn(jnp.asarray(x), jidx, jnp.asarray(w), jpos, jkeep, cap,
               jnp.asarray(wi), jnp.asarray(wg), jnp.asarray(wo), JF.silu)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in (x, w, wi, wg, wo)))
    targs = [torch.tensor(a).requires_grad_(True) for a in (x, w, wi, wg,
                                                            wo)]
    out = tfn(targs[0], torch.tensor(idx).long(), targs[1],
              torch.tensor(pos).long(), torch.tensor(keep), cap, targs[2],
              targs[3], targs[4], F.silu)
    (out * torch.tensor(ct)).sum().backward()
    np.testing.assert_allclose(_f32(out), np.asarray(jval), rtol=1e-4,
                               atol=1e-5)
    for name, a, b in zip(("x", "w", "w_in", "w_gate", "w_out"), targs,
                          jgrads):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    dead = ~keep
    if capfac < 1:
        assert dead.any()
        assert (targs[1].grad.numpy()[dead] == 0).all()   # dropped: exact 0


def test_gates_match_jax_and_the_kernel_wrappers_raise_on_cpu():
    """The port's gate equals the JAX one, among others at the Qwen2-MoE
    slices' shapes (T 8192, D 1024, E 16, capacity 1280): in fp32 both
    admit the expert width 512 and reject bench.py's 704 (the VMEM
    term), so the fp32 slice runs the fp32 kernels at H 512."""
    for args in [(256, 128, 64, 4, 160), (64, 96, 32, 4, 32),
                 (8192, 1024, 704, 16, 1280), (8192, 1024, 4096, 16, 1280),
                 (8192, 1024, 512, 16, 1280), (8192, 1024, 640, 16, 1280)]:
        for dt in ("float32", "bfloat16"):
            for act, gated in ((JF.silu, True), (JF.relu, False)):
                want = jax_gg.fused_dispatch_applicable(*args, JDT[dt], act,
                                                        gated)
                got = gg.fused_dispatch_applicable(
                    *args, TDT[dt], F.silu if gated else torch.relu, gated)
                assert got == want, (args, dt, gated)
    for H, admitted in ((512, True), (640, True), (704, False)):
        assert gg.fused_dispatch_applicable(8192, 1024, H, 16, 1280,
                                            torch.float32, F.silu,
                                            True) == admitted, H
    assert [gg.padded_capacity(c) for c in (4, 40, 128, 1280, 1300)] == \
        [jax_gg.padded_capacity(c) for c in (4, 40, 128, 1280, 1300)]
    x = torch.zeros((T, D), dtype=torch.bfloat16)
    w = torch.zeros((E, D, 64), dtype=torch.bfloat16)
    for dt in (torch.bfloat16, torch.float32):
        x, w = x.to(dt), w.to(dt)
        with pytest.raises(ValueError, match="CUDA"):
            gg.moe_fwd_cuda(x, torch.zeros((E, 128), dtype=torch.int32),
                            torch.zeros((E, 128)), w, w,
                            w.transpose(1, 2).contiguous(), "silu")
