"""``nn.functional.dropout`` and ``nn.Dropout`` of the port against the JAX
package's (``paddle_tpu/nn/functional/common.py:31-45``, ``nn/layer/
common.py:85``).

The port draws its keep mask from a ``torch.Generator``, the JAX package
from ``jax.random``; the bits differ (ROADMAP.md A1). So:

- every case that draws no bits is held to the JAX function exactly:
  eval mode and ``p == 0`` in both modes (the identity, or ``x * (1 -
  p)`` with ``downscale_in_infer``), and ``p == 1`` (zeros);
- the cases that draw are held to their definition: every output is 0
  or ``x / (1 - p)`` (``upscale_in_train``) / ``x`` (``downscale_in_
  infer``), the keep rate within 4 standard deviations of ``1 - p``,
  ``axis`` broadcasting one mask over the other dimensions, and two runs
  from one generator state bitwise equal (another state differs);
- the attention core below ``FLASH_MIN_SEQ`` rows (the counterpart of
  ``_xla_attention``'s dropout, attention.py:77-80) applies the mask
  drawn from the generator: equal to the composition with that mask.

Tolerances: exact (``torch.equal``) where both sides compute the same
expression; fp32 1e-6 relative for the attention composition (one
einsum against another, sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.nn.functional as JF
from paddle_tpu_torch.nn import Dropout
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.functional.attention import _plain_attention
from torch_one_thread import one_torch_thread  # noqa: F401

MODES = ("upscale_in_train", "downscale_in_infer")


def _x(seed=0, shape=(4, 33, 16)):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("p,training", [(0.3, False), (0.0, True),
                                        (0.0, False), (1.0, True),
                                        (1.0, False)])
def test_cases_without_draws_equal_jax(p, training, mode):
    x = _x()
    want = np.asarray(JF.dropout(jnp.asarray(x), p=p, training=training,
                                 mode=mode))
    got = F.dropout(torch.tensor(x), p=p, training=training, mode=mode)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("p", [0.1, 0.5])
def test_drawn_mask_keeps_rate_and_scale(p, mode):
    x = torch.tensor(_x(1, (64, 512))) + 5.0     # no zero inputs
    g = torch.Generator().manual_seed(3)
    y = F.dropout(x, p=p, mode=mode, generator=g)
    kept = y != 0
    want = x / (1.0 - p) if mode == "upscale_in_train" else x
    assert torch.equal(y[kept], want[kept])
    n = x.numel()
    rate = kept.float().mean().item()
    assert abs(rate - (1 - p)) <= 4 * np.sqrt(p * (1 - p) / n), rate


def test_generator_reproduces_and_axis_broadcasts():
    x = torch.tensor(_x(2, (8, 16, 32))) + 5.0
    a = F.dropout(x, p=0.5, generator=torch.Generator().manual_seed(7))
    b = F.dropout(x, p=0.5, generator=torch.Generator().manual_seed(7))
    c = F.dropout(x, p=0.5, generator=torch.Generator().manual_seed(8))
    assert torch.equal(a, b) and not torch.equal(a, c)
    y = F.dropout(x, p=0.5, axis=[0, 2],
                  generator=torch.Generator().manual_seed(1))
    kept = y != 0                          # one mask over dimension 1
    assert torch.equal(kept, kept[:, :1, :].expand_as(kept))
    assert 0 < kept.float().mean().item() < 1


def test_dropout_layer_holds_its_generator():
    layer = Dropout(0.25, generator=torch.Generator().manual_seed(5))
    x = torch.tensor(_x(3)) + 5.0
    y1 = layer(x)
    layer.generator.manual_seed(5)
    assert torch.equal(layer(x), y1)
    layer.eval()
    assert torch.equal(layer(x), x)
    with pytest.raises(ValueError, match="mode"):
        F.dropout(x, p=0.5, mode="bogus")


def test_plain_attention_dropout_is_the_composition_with_its_mask():
    """Below FLASH_MIN_SEQ the core draws ``rand(probs.shape) < 1 - p``
    from the generator and scales kept probabilities by 1 / (1 - p)."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.tensor(rng.standard_normal((2, 16, 3, 64)),
                            dtype=torch.float32) for _ in range(3))
    p = 0.2
    got = _plain_attention(q, k, v, is_causal=True, dropout_p=p,
                           generator=torch.Generator().manual_seed(11))
    keep = torch.rand((2, 3, 16, 16),
                      generator=torch.Generator().manual_seed(11)) < 1 - p
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / 8.0
    s = s.masked_fill(~torch.ones(16, 16, dtype=torch.bool).tril(), -np.inf)
    probs = torch.where(keep, torch.softmax(s, -1) / (1 - p), 0.0)
    want = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    sdpa = F.scaled_dot_product_attention(
        q, k, v, dropout_p=p, is_causal=True,
        generator=torch.Generator().manual_seed(11))
    assert torch.equal(sdpa, got)
    assert torch.equal(F.scaled_dot_product_attention(
        q, k, v, dropout_p=p, is_causal=True, training=False),
        _plain_attention(q, k, v, is_causal=True))
