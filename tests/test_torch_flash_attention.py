"""The port's flash attention (plain versions, the CPU path) against the
JAX package's Pallas flash kernels, which run in interpret mode on the
CPU (as tests/test_flash_attention.py runs them).

- ``flash_fwd_plain`` against ``flash_attention_with_lse`` and
  ``flash_block_grads_plain`` against ``flash_block_grads`` (given the
  same lse and delta), over s 256 and 320 (one and several Pallas
  blocks; 320 is not a power of two), d 32 and 64, fp32 and bf16, causal
  and not, and ``sq != sk`` both ways (bottom-right causal alignment,
  with fully masked rows when ``sq > sk``);
- autograd through the port's ``flash_attention`` against ``jax.grad`` of
  the JAX one;
- the routing of ``scaled_dot_product_attention`` and the modes that are
  not ported.

Tolerances: fp32 2e-5 absolute and relative — the same fp32 arithmetic
in one block instead of the online softmax over Pallas blocks, so only
the order of the sums and the rescaling differ. bf16: one bf16 ulp
(``rtol = 2**-7``, ``atol = 2**-9``) — both compute in fp32 from the same
bf16 inputs and round once to bf16, and a rounding can land on the
neighbouring value. ``lse`` is fp32 in both dtypes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as J
from paddle_tpu_torch.nn.functional import scaled_dot_product_attention
from paddle_tpu_torch.nn.functional.attention import (FLASH_MIN_SEQ,
                                                      _plain_attention)
from paddle_tpu_torch.ops.kernels import (flash_bwd_dkv_cuda,
                                          flash_bwd_dq_cuda, flash_delta,
                                          flash_fwd_cuda, launch_counts)
from paddle_tpu_torch.ops.kernels import flash_attention as T

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, shapes, dtype):
    """Arrays exactly representable in ``dtype``, as (jax, torch) pairs."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in shapes:
        a = rng.standard_normal(shape).astype(np.float32)
        a = np.asarray(jnp.asarray(a, JDT[dtype]).astype(jnp.float32))
        out.append((jnp.asarray(a, JDT[dtype]), torch.tensor(a).to(TDT[dtype])))
    return out


def _close(got, want, dtype):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -9)


CASES = [(s, s, d, dtype, causal)
         for s in (256, 320) for d in (32, 64)
         for dtype in ("float32", "bfloat16") for causal in (False, True)]
CASES += [(256, 320, 32, "float32", True), (320, 256, 64, "bfloat16", True)]


def _jax_fwd_bwd(q, k, v, do, delta, causal):
    """The JAX forward and, from its lse and the given delta, the JAX
    backward, compiled as one program (one interpret-mode compile)."""
    scale = 1.0 / np.sqrt(q.shape[-1])

    def run(q, k, v, do, delta):
        o, lse = J.flash_attention_with_lse(q, k, v, causal=causal)
        return (o, lse) + tuple(J.flash_block_grads(
            q, k, v, do, lse, delta, scale=scale, causal=causal))

    return jax.jit(run)(q, k, v, do, delta)


@pytest.mark.parametrize("sq,sk,d,dtype,causal", CASES)
def test_flash_plain_versions_match_pallas(sq, sk, d, dtype, causal):
    b, h = 1, 2
    scale = 1.0 / np.sqrt(d)
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = _inputs(
        sq * 1000 + sk + d, [(b, sq, h, d), (b, sk, h, d), (b, sk, h, d),
                             (b, sq, h, d)], dtype)
    before = launch_counts()
    to, tl = T.flash_fwd_plain(tq, tk, tv, scale, causal)
    delta = flash_delta(tdo, to)
    jo, jl, *jg = _jax_fwd_bwd(jq, jk, jv, jdo, jnp.asarray(delta.numpy()),
                               causal)
    assert to.dtype == TDT[dtype] and tl.dtype == torch.float32
    assert tuple(tl.shape) == (b, h, sq)
    _close(to, jo, dtype)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-5,
                               atol=2e-5)
    if causal and sq > sk:   # rows that see no key: out 0, lse -1e30
        assert (tl[:, :, :sq - sk] == T.NEG).all()
        assert (to[:, :sq - sk] == 0).all()
    # the backward from the same statistics (the JAX lse, the port's delta)
    lse = torch.tensor(np.asarray(jl))
    tg = T.flash_block_grads_plain(tq, tk, tv, tdo, lse, delta, scale,
                                   causal)
    for got, want, ref in zip(tg, jg, (tq, tk, tv)):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        _close(got, want, dtype)
    assert launch_counts() == before   # CPU tensors launch nothing


@pytest.mark.parametrize("causal", [False, True])
def test_flash_autograd_matches_jax_grad(causal):
    """d(sum(out * c)) through the port's autograd Function and through
    the JAX custom_vjp, fp32, s 320 (several Pallas blocks)."""
    b, s, h, d = 2, 320, 2, 32
    (jq, tq), (jk, tk), (jv, tv), (jc, tc) = _inputs(
        7 + causal, [(b, s, h, d)] * 4, "float32")

    def jloss(q, k, v):
        return jnp.sum(J.flash_attention(q, k, v, causal=causal) * jc)

    jval, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    out = T.flash_attention(*leaves, causal=causal)
    tval = (out * tc).sum()
    tval.backward()
    np.testing.assert_allclose(tval.item(), float(jval), rtol=2e-5)
    for leaf, want in zip(leaves, jgrads):
        _close(leaf.grad, want, "float32")


def test_sdpa_routes_to_flash_from_256_rows():
    rng = np.random.default_rng(3)
    for s in (FLASH_MIN_SEQ - 1, FLASH_MIN_SEQ):
        q, k, v = (torch.tensor(rng.standard_normal((1, s, 2, 64)),
                                dtype=torch.float32) for _ in range(3))
        got = scaled_dot_product_attention(q, k, v, is_causal=True)
        flash, _ = T.flash_fwd_plain(q, k, v, 64 ** -0.5, True)
        plain = _plain_attention(q, k, v, is_causal=True)
        if s >= FLASH_MIN_SEQ:
            torch.testing.assert_close(got, flash, rtol=0, atol=0)
        else:
            torch.testing.assert_close(got, plain, rtol=0, atol=0)
        torch.testing.assert_close(flash, plain, rtol=2e-5, atol=2e-5)


def test_unported_modes_and_cpu_tensors_raise():
    q = torch.zeros((1, 256, 2, 64))
    lse = torch.zeros((1, 2, 256))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.flash_attention(q, q, q, attn_mask=torch.zeros(256, 256))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.flash_attention(q, q, q, dropout_p=0.1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.flash_block_grads(q, q, q, q, lse, lse, scale=0.125,
                            causal=True, seg=(np.zeros(256), np.zeros(256)))
    # the wrappers launch on CUDA tensors or raise: never a CPU fallback
    with pytest.raises(ValueError, match="CUDA"):
        flash_fwd_cuda(q, q, q, 0.125, True)
    with pytest.raises(ValueError, match="CUDA"):
        flash_bwd_dq_cuda(q, q, q, q, lse, lse, 0.125, True)
    with pytest.raises(ValueError, match="CUDA"):
        flash_bwd_dkv_cuda(q, q, q, q, lse, lse, 0.125, True)
