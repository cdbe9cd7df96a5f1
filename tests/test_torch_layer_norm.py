"""The port's LayerNorm (plain version, the CPU path) against the JAX
package's ``fused_layer_norm``, which runs its Pallas kernel in
interpret mode on the CPU when ``d % 128 == 0`` (d 128 and 256 here) and
its XLA composition otherwise (d 96).

- forward at row counts that are a multiple of the Pallas ``_rows_block``
  (512 rows: one 256-row block twice) and that are not (15 rows: padded
  to 16), eps 1e-12 (BERT's encoder) and 1e-5 (its ``mlm_norm``), fp32
  and bf16;
- autograd (dx, dw, db) through the port's Function against
  ``jax.grad`` of ``fused_layer_norm`` (Pallas forward, closed-form
  ``_ln_bwd``);
- a no-grad call (the router skips the Function), the ``LayerNorm``
  layer, and the functional's fp32 composition (no weight, two
  normalised axes) against JAX's ``F.layer_norm``.

Inputs come from numpy, seeded; bf16 inputs are rounded once and the
same values go to both packages.

Tolerances: fp32 2e-5 relative and absolute (same arithmetic, sums in
another order); bf16 one bf16 ulp (``rtol = 2**-7``): both round the same
fp32 value once, whose last bits depend on the order of the sums.
Gradients in bf16: one bf16 ulp of the value plus 1e-5 (they too are one
rounding of fp32 sums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.nn.functional as JF
from paddle_tpu.ops.pallas.fused_norm import fused_layer_norm
from paddle_tpu_torch.nn import LayerNorm
from paddle_tpu_torch.nn.functional import layer_norm
from paddle_tpu_torch.ops.kernels import (launch_counts, layer_norm_cuda,
                                          layer_norm_plain)
from torch_one_thread import one_torch_thread  # noqa: F401

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a, dtype):
    """``a`` rounded to ``dtype``, as (jax, torch) arrays of equal value."""
    a = np.asarray(jnp.asarray(np.asarray(a, np.float32), JDT[dtype])
                   .astype(jnp.float32))
    return jnp.asarray(a, JDT[dtype]), torch.tensor(a).to(TDT[dtype])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, dtype, atol=2e-5):
    if dtype == "float32":
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-5,
                                   atol=atol)
    else:
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=2 ** -7,
                                   atol=1e-6 if atol == 2e-5 else atol)


def _inputs(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    d = shape[-1]
    x = _pair(rng.standard_normal(shape) * 3 + 0.5, dtype)
    w = _pair(rng.standard_normal(d), dtype)
    b = _pair(rng.standard_normal(d), dtype)
    return x, w, b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("eps", [1e-12, 1e-5])
@pytest.mark.parametrize("shape", [(3, 5, 128), (4, 128, 128), (3, 5, 256),
                                   (4, 128, 256), (3, 5, 96)])
def test_layer_norm_matches_jax(shape, eps, dtype):
    (jx, tx), (jw, tw), (jb, tb) = _inputs(sum(shape), shape, dtype)
    want = fused_layer_norm(jx, jw, jb, eps)
    before = launch_counts()
    got = layer_norm(tx, shape[-1], tw, tb, eps)
    assert launch_counts() == before   # a CPU tensor takes the plain path
    assert got.dtype == TDT[dtype] and got.shape == tx.shape
    _close(got, want, dtype)
    torch.testing.assert_close(got, layer_norm_plain(tx, tw, tb, eps),
                               rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 5, 128), (2, 256, 256), (3, 5, 96)])
def test_layer_norm_autograd_matches_jax_grad(shape, dtype):
    (jx, tx), (jw, tw), (jb, tb) = _inputs(7 + shape[-1], shape, dtype)
    (jc, tc), = [_pair(np.random.default_rng(1).standard_normal(shape),
                       "float32")]

    def jloss(x, w, b):
        return jnp.sum(fused_layer_norm(x, w, b, 1e-12).astype(jnp.float32)
                       * jc)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jx, jw, jb)
    leaves = [t.clone().requires_grad_(True) for t in (tx, tw, tb)]
    y = layer_norm(*[leaves[0], shape[-1], leaves[1], leaves[2]], 1e-12)
    assert y.grad_fn is not None
    (y.float() * tc).sum().backward()
    for leaf, want in zip(leaves, jgrads):
        assert leaf.grad.dtype == TDT[dtype]
        _close(leaf.grad, want, dtype, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_without_grad_matches_jax(dtype):
    """Under no_grad the router skips the autograd Function: no graph,
    the same values as the JAX forward."""
    (jx, tx), (jw, tw), (jb, tb) = _inputs(5, (4, 7, 256), dtype)
    with torch.no_grad():
        y = layer_norm(tx, 256, tw.requires_grad_(True), tb, 1e-5)
    assert y.grad_fn is None and y.dtype == TDT[dtype]
    _close(y, fused_layer_norm(jx, jw, jb, 1e-5), dtype)


def test_layer_norm_layer_and_composition_match_jax():
    rng = np.random.default_rng(0)
    jx, tx = _pair(rng.standard_normal((2, 6, 4, 32)) * 2, "float32")
    layer = LayerNorm(32, epsilon=1e-12, device="cpu", dtype=torch.float32)
    layer.reset_parameters(torch.Generator().manual_seed(0))
    assert (layer.weight == 1).all() and (layer.bias == 0).all()
    ones, zeros = jnp.ones(32), jnp.zeros(32)
    _close(layer(tx), JF.layer_norm(jx, 32, ones, zeros, 1e-12), "float32")
    # two normalised axes, no weight: the fp32 composition in both
    _close(layer_norm(tx, (4, 32), None, None, 1e-5),
           JF.layer_norm(jx, (4, 32), None, None, 1e-5), "float32")
    jw, tw = _pair(rng.standard_normal(32), "float32")
    _close(layer_norm(tx, 32, tw, None, 1e-5),
           JF.layer_norm(jx, 32, jw, None, 1e-5), "float32")


def test_layer_norm_cuda_raises_on_cpu_tensors():
    """The wrapper launches on CUDA tensors or raises: never a CPU
    fallback."""
    x = torch.zeros((4, 128))
    with pytest.raises(ValueError, match="CUDA"):
        layer_norm_cuda(x, torch.ones(128), torch.zeros(128), 1e-5)
