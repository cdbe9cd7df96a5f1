"""The port's RMSNorm (plain version, the CPU path) against the JAX
package's ``fused_rms_norm``, which runs its Pallas kernel in interpret
mode on the CPU when ``d % 128 == 0`` and its XLA composition otherwise.

Inputs are made with numpy from a seed; bf16 inputs are rounded once
and the same values go to both packages.

Tolerances: fp32 1e-5 (same arithmetic, sums in another order); bf16
one bf16 ulp (``rtol = 2**-7``): both round the same fp32 value, whose
last bits depend on the order of the sums.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.fused_norm import fused_rms_norm
from paddle_tpu_torch.nn import RMSNorm
from paddle_tpu_torch.nn.functional import rms_norm
from paddle_tpu_torch.ops.kernels import launch_counts
from torch_one_thread import one_torch_thread  # noqa: F401

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _same_inputs(rng, shape, dtype):
    """A numpy array exactly representable in ``dtype``, plus its JAX
    and torch versions."""
    a = rng.standard_normal(shape).astype(np.float32) * 3
    a = np.asarray(jnp.asarray(a, JDT[dtype]).astype(jnp.float32))
    return jnp.asarray(a, JDT[dtype]), torch.tensor(a).to(TDT[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [128, 256, 96])
def test_rms_norm_matches_jax(d, dtype):
    rng = np.random.default_rng(d)
    jx, tx = _same_inputs(rng, (3, 5, d), dtype)
    jw, tw = _same_inputs(rng, (d,), dtype)
    want = np.asarray(fused_rms_norm(jx, jw, 1e-6).astype(jnp.float32))
    before = launch_counts()
    got = rms_norm(tx, tw, 1e-6)
    assert launch_counts() == before   # a CPU tensor takes the plain path
    assert got.dtype == TDT[dtype] and got.shape == tx.shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                                   atol=1e-6)


def test_rms_norm_layer_and_no_weight_form():
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((4, 64)).astype(np.float32))
    layer = RMSNorm(64, 1e-6, device="cpu", dtype=torch.float32)
    layer.reset_parameters(torch.Generator().manual_seed(0))
    torch.testing.assert_close(layer(x), rms_norm(x, None, 1e-6))
    want = x / torch.sqrt((x * x).mean(-1, keepdim=True) + 1e-6)
    torch.testing.assert_close(rms_norm(x, None, 1e-6), want, rtol=1e-6,
                               atol=1e-6)
