"""The port's CUDA kernels against their plain PyTorch versions, on the
card (marker ``cuda``). Without a CUDA device every test skips from
the ``cuda`` fixture. On a machine with one, run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the shared conftest imports JAX, which a GPU machine
without JAX cannot load; these tests import only torch and the port).

Tolerances, each with its reason:
- fp32: 2e-5 absolute. Same arithmetic, sums taken in another order,
  and ``rsqrtf``/``expf`` within 2 ulp of PyTorch's.
- bf16 RMSNorm: one bf16 ulp (``rtol = 2**-7``): both round the same
  fp32 value, which can differ in its last bits by summation order.
- bf16 paged attention (a bf16 pool): 1e-2 absolute, two bf16 ulps at
  ``|out| < 2``. q, the probabilities and the output are each rounded to
  bf16, and a rounding can flip by one ulp when the fp32 sums before it
  are taken in another order.
- flash forward, dQ and dK/dV (bf16 only), against the plain versions
  run on fp32 copies of the inputs (outputs not rounded to bf16): each
  row within ``2**-7`` of its own largest magnitude plus 1e-3, and each
  output within 4e-3 in relative Frobenius norm. The kernels round their
  outputs to bf16 (at most 2**-8 of a row's largest magnitude; ~1.7e-3
  relative in Frobenius norm) and P and dS to bf16 as tensor-core
  operands where the plain versions keep fp32. A row-wise bound, not
  one from the whole output's largest value: in causal attention the
  first rows are far larger than the rest. lse 1e-4 absolute (exact
  bf16 products, sums in another order). The backward has no atomics,
  so two launches on the same inputs are bitwise equal.
- int8 paged attention (int8 codes with fp32 row scales), against the
  plain version on the same pools: fp32 q 2e-5 absolute (the core's
  arithmetic: K and V dequantized per element in fp32, q and the
  probabilities not rounded; sums in another order); bf16 q one bf16
  ulp of max(|out|, 2**-8) (``rtol = 2**-7``, ``atol = 2**-15``): both
  round the same fp32 output once, and near zero a cancelling sum's
  fp32 rounding (~1e-6) is many ulps of the output itself.
- ``Int8ServingLinear`` on the card (bf16 x: one ``torch.mm`` with fp32
  sums) against its CPU form (fp32 product): one bf16 ulp.
- a training step, kernels vs plain versions, bf16 model: loss 1e-2
  absolute and each gradient 5e-2 in relative L2 — bf16 gradients carry
  2**-8 relative rounding per element through every layer's products.
- bf16 LayerNorm: one bf16 ulp (``rtol = 2**-7``) as RMSNorm; fp32
  2e-5. Its autograd (the same closed-form backward on both paths, from
  outputs that may differ by an ulp): as RMSNorm's.
- the flash bias mode: the flash rule above, against the plain versions
  given the same fp32 bias; fully masked rows exact (out 0, lse -1e30).
- a BERT training step, kernels vs plain versions, bf16: the training
  step's rule above, the loss's 1e-2 scaled by the loss over 10 (its
  MLM logits, ~16 in magnitude through the N(0, 1) tied embedding,
  round at 2**-4 in bf16); a key projection's bias, whose exact
  gradient is 0, against the norm of its weight's gradient.
"""

import contextlib

import numpy as np
import pytest
import torch

from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (BertConfig, BertForPreTraining,
                                     LlamaConfig, LlamaForCausalLM,
                                     llama_tiny)
from paddle_tpu_torch.nn.functional import rms_norm
from paddle_tpu_torch.ops.kernels import flash_attention as FA
from paddle_tpu_torch.ops.kernels import (launch_counts, layer_norm,
                                          layer_norm_cuda, layer_norm_plain,
                                          paged_attention_cuda,
                                          paged_attention_plain,
                                          plain_reference,
                                          reset_launch_counts, rms_norm_cuda,
                                          rms_norm_plain)
from paddle_tpu_torch.ops.kernels.philox import keep_mask
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.quantization import (Int8ServingLinear, kv_quantize,
                                           quantize_for_serving,
                                           quantize_weight)
from paddle_tpu_torch.serving import ServingEngine
from torch_one_thread import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.cuda

DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _counts(**nonzero):
    """Every kernel's launch count: 0 but for ``nonzero``."""
    out = dict.fromkeys(launch_counts(), 0)
    out.update(nonzero)
    return out


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d", [(8, 4096), (512, 4096), (3, 96),
                                 (5, 8192)])
def test_rms_norm_kernel_matches_plain(cuda, n, d, dtype):
    rng = np.random.default_rng(n * d)
    x = torch.tensor(rng.standard_normal((n, d)) * 3, dtype=DT[dtype],
                     device=cuda)
    w = torch.tensor(rng.standard_normal(d), dtype=DT[dtype], device=cuda)
    got = rms_norm_cuda(x, w, 1e-6)
    torch.cuda.synchronize()
    want = rms_norm_plain(x, w, 1e-6)
    if dtype == "float32":
        torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=1e-6,
                                   rtol=2 ** -7)


def _paged_inputs(rng, b, h, kvh, d, ps, lens, qdt, cdt, device):
    """Ragged slots over distinct random pages; a slot with length None
    is inactive (seq_lens 0, table all scratch page 0)."""
    M = max(-(-(n + 1) // ps) for n in lens if n is not None) + 1
    n_pages = b * M + 1
    perm = rng.permutation(np.arange(1, n_pages))
    tables = np.zeros((b, M), np.int32)
    seq = np.zeros(b, np.int32)
    for s, n in enumerate(lens):
        if n is None:
            continue
        live = -(-(n + 1) // ps)
        tables[s, :live] = perm[s * M:s * M + live]
        seq[s] = n
    pk = rng.standard_normal((n_pages, ps, kvh, d))
    pv = rng.standard_normal((n_pages, ps, kvh, d))
    q = rng.standard_normal((b, 1, h, d))
    t = lambda a, dt: torch.tensor(a, dtype=dt, device=device)  # noqa: E731
    return (t(q, qdt), t(pk, cdt), t(pv, cdt), t(tables, torch.int32),
            t(seq, torch.int32))


@pytest.mark.parametrize("qdt,cdt", [("float32", "float32"),
                                     ("float32", "bfloat16"),
                                     ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("g,d,ps", [(1, 128, 16), (2, 64, 8), (4, 128, 16),
                                    (4, 64, 16), (8, 128, 5)])
def test_paged_kernel_matches_plain(cuda, qdt, cdt, g, d, ps):
    rng = np.random.default_rng(g * 1000 + d + ps)
    kvh = 2
    # page-boundary lengths (k*ps - 1, k*ps), a first-position page,
    # an inactive slot and a ~300-token context
    lens = [ps - 1, ps, 2 * ps, None, 300, 0, 3 * ps + 1]
    args = _paged_inputs(rng, len(lens), g * kvh, kvh, d, ps, lens,
                         DT[qdt], DT[cdt], cuda)
    got = paged_attention_cuda(*args)
    torch.cuda.synchronize()
    want = paged_attention_plain(*args)
    assert got.dtype == want.dtype == DT[qdt]
    tol = 2e-5 if cdt == "float32" else 1e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)


def test_paged_kernel_raises_outside_its_gate(cuda):
    rng = np.random.default_rng(0)
    q, pk, pv, tables, seq = _paged_inputs(
        rng, 2, 4, 2, 128, 16, [5, 40], torch.float32, torch.float32, cuda)
    with pytest.raises(ValueError, match="q must be"):
        paged_attention_cuda(q.expand(2, 2, 4, 128).contiguous(), pk, pv,
                             tables, seq)
    with pytest.raises(ValueError, match="head dim"):
        paged_attention_cuda(q[..., :96].contiguous(),
                             pk[..., :96].contiguous(),
                             pv[..., :96].contiguous(), tables, seq)
    with pytest.raises(ValueError, match="int32"):
        paged_attention_cuda(q, pk, pv, tables.long(), seq)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        paged_attention_cuda(q.half(), pk, pv, tables, seq)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        rms_norm_cuda(q.half(), q.new_ones(128).half(), 1e-6)
    with pytest.raises(ValueError, match="d in"):
        rms_norm_cuda(q.new_ones(2, 9000), q.new_ones(9000), 1e-6)


def _small_llama(cuda, dtype="bfloat16"):
    """Two layers, head_dim 64 (the flash kernels take 64 and 128)."""
    cfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=512,
                      dtype=dtype)
    return LlamaForCausalLM(cfg, device=cuda, seed=3)


def test_uncached_forward_launches_flash_at_256_rows(cuda):
    model = _small_llama(cuda)
    ids = torch.tensor(np.random.default_rng(1).integers(0, 512, (2, 256)),
                       device=cuda)
    reset_launch_counts()
    with torch.no_grad():
        logits = model(ids)
    torch.cuda.synchronize()
    L = model.config.num_hidden_layers
    assert launch_counts() == _counts(rms_norm=2 * L + 1, flash_fwd=L)
    assert torch.isfinite(logits.float()).all()
    with torch.no_grad():
        short = model(ids[:, :255])
    assert launch_counts()["flash_fwd"] == L   # s < 256: the plain core
    assert torch.isfinite(short.float()).all()


def _flash_inputs(b, sq, sk, h, d, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    shapes = [(b, sq, h, d), (b, sk, h, d), (b, sk, h, d), (b, sq, h, d)]
    return [torch.randn(s, generator=g, device=device).to(DT[dtype])
            for s in shapes]


def _assert_flash_close(got, want32):
    """A bf16 kernel output against the fp32 plain one: every row within
    2**-7 of its largest magnitude plus 1e-3, and 4e-3 in relative
    Frobenius norm."""
    diff = got.float() - want32
    row_tol = 2 ** -7 * want32.abs().amax(-1) + 1e-3
    worst = (diff.abs().amax(-1) / row_tol).max().item()
    fro = (diff.norm() / want32.norm().clamp(min=1e-30)).item()
    assert worst <= 1.0 and fro <= 4e-3, (worst, fro)


@pytest.mark.parametrize("b,sq,sk,h,d,causal", [
    (2, 256, 256, 4, 128, True),
    (1, 2048, 2048, 2, 128, True),
    (2, 1000, 1000, 3, 64, False),
    (2, 1000, 1000, 3, 64, True),
    (1, 700, 1000, 2, 128, True),
    (1, 1000, 700, 2, 128, True),
    (1, 64, 64, 1, 64, False),
    (2, 300, 300, 2, 128, True),
    (1, 333, 517, 2, 64, False),
])
def test_flash_kernels_match_plain(cuda, b, sq, sk, h, d, causal):
    q, k, v, do = _flash_inputs(b, sq, sk, h, d, "bfloat16", cuda)
    scale = d ** -0.5
    reset_launch_counts()
    out, lse = FA.flash_fwd_cuda(q, k, v, scale, causal)
    q32, k32, v32, do32 = (x.float() for x in (q, k, v, do))
    want_o, want_l = FA.flash_fwd_plain(q32, k32, v32, scale, causal)
    delta = FA.flash_delta(do, want_o.bfloat16())
    grads = (FA.flash_bwd_dq_cuda(q, k, v, do, want_l, delta, scale, causal),
             *FA.flash_bwd_dkv_cuda(q, k, v, do, want_l, delta, scale,
                                    causal))
    torch.cuda.synchronize()
    assert launch_counts() == _counts(flash_fwd=1, flash_dq=1, flash_dkv=1)
    want_g = FA.flash_block_grads_plain(q32, k32, v32, do32, want_l, delta,
                                        scale, causal)
    for got, want in zip((out,) + grads, (want_o,) + want_g):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        _assert_flash_close(got, want)
    dead = want_l <= -1e29
    assert torch.equal(lse <= -1e29, dead)
    assert (out.transpose(1, 2)[dead] == 0).all()
    live_err = (lse - want_l)[~dead].abs().max().item()
    assert live_err <= 1e-4, live_err


@pytest.mark.parametrize("d,causal,scores", [
    (64, True, "random"), (128, False, "random"), (64, False, "far"),
    (128, True, "far")])
def test_flash_backward_plain_mode_views_and_repeats(cuda, d, causal,
                                                     scores):
    """The plain bf16 backward (the wgmma kernels) on q, k, v, dO as views
    of one [b, s, 4, h, d] tensor at a ragged length: against the plain
    versions, and two launches bitwise equal. ``far``: every 7th query
    scores far below 0 on every key and has a zero upstream gradient
    (``chip_smoke.FLASH_CASES``), so a key past the end (TMA's zeros)
    would take P = inf there but for its mask."""
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((2, 333, 4, 3, d), generator=g, device=cuda)
    if scores == "far":
        x[:, ::7, 0] = -32.0
        x[:, :, 1] += 1.0
        x[:, ::7, 3] = 0.0
    q, k, v, do = x.bfloat16().unbind(2)
    assert not q.is_contiguous()
    scale = d ** -0.5
    q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
    want_o, want_l = FA.flash_fwd_plain(q32, k32, v32, scale, causal)
    delta = FA.flash_delta(do, want_o.bfloat16())
    runs = [(FA.flash_bwd_dq_cuda(q, k, v, do, want_l, delta, scale, causal),
             *FA.flash_bwd_dkv_cuda(q, k, v, do, want_l, delta, scale,
                                    causal)) for _ in range(2)]
    torch.cuda.synchronize()
    want_g = FA.flash_block_grads_plain(q32, k32, v32, do32, want_l, delta,
                                        scale, causal)
    for got, again, want in zip(*runs, want_g):
        assert torch.equal(got, again)
        _assert_flash_close(got, want)


def test_flash_kernels_take_strided_views(cuda):
    """q, k, v as views of one [b, s, 3, h, d] projection: read through
    their strides, no copy."""
    qkv = torch.randn((2, 384, 3, 4, 64), device=cuda).bfloat16()
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    out, lse = FA.flash_fwd_cuda(q, k, v, 0.125, True)
    want, _ = FA.flash_fwd_plain(q.float(), k.float(), v.float(), 0.125,
                                 True)
    torch.cuda.synchronize()
    _assert_flash_close(out, want)


def test_flash_raises_outside_its_gate(cuda):
    q, k, v, do = _flash_inputs(1, 256, 256, 2, 64, "bfloat16", cuda)
    lse0 = torch.zeros((1, 2, 256), device=cuda)
    with pytest.raises(ValueError, match="segment ids with a bias or "
                                         "with dropout"):
        FA.flash_block_grads(q, k, v, do, lse0, lse0, scale=0.125,
                             causal=True, seg=(np.zeros(256), np.zeros(256)),
                             bias=torch.zeros((256, 256), device=cuda))
    with pytest.raises(ValueError, match="segment ids with a bias or "
                                         "with dropout"):
        FA.flash_fwd_cuda(q, k, v, 0.125, True, None, 0.1,
                          torch.tensor([1, 2], device=cuda),
                          seg=(np.zeros(256), np.zeros(256)))
    with pytest.raises(ValueError, match="float32"):
        FA.flash_fwd_cuda(q, k, v, 0.125, False,
                          torch.zeros((1, 1, 256, 256), device=cuda).half())
    with pytest.raises(ValueError, match=r"\[b\|1, h\|1, sq, sk\]"):
        FA.flash_fwd_cuda(q, k, v, 0.125, False,
                          torch.zeros((1, 3, 256, 256), device=cuda))
    with pytest.raises(ValueError, match="device"):
        FA.flash_bwd_dq_cuda(q, k, v, do, torch.zeros((1, 2, 256),
                                                      device=cuda),
                             torch.zeros((1, 2, 256), device=cuda), 0.125,
                             False, torch.zeros((1, 1, 256, 256)))
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_fwd_cuda(*(torch.zeros((1, 256, 2, 96), device=cuda)
                            .bfloat16() for _ in range(3)), 0.1, True)
    with pytest.raises(ValueError, match="share one dtype"):
        FA.flash_fwd_cuda(q.half(), k.half(), v.half(), 0.125, True)
    with pytest.raises(ValueError, match="share one dtype"):
        FA.flash_fwd_cuda(q, k.float(), v, 0.125, True)
    with pytest.raises(ValueError, match="share one dtype"):   # fp64 too
        FA.flash_fwd_cuda(q.double(), k.double(), v.double(), 0.125, True)
    with pytest.raises(ValueError, match="seed_arr"):
        FA.flash_fwd_cuda(q, k, v, 0.125, True, None, 0.1)
    with pytest.raises(ValueError, match="int64"):
        FA.flash_fwd_cuda(q, k, v, 0.125, True, None, 0.1,
                          torch.zeros(2, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        FA.flash_fwd_cuda(q, k, v, 0.125, True, None, 1.0,
                          torch.zeros(2, dtype=torch.int64, device=cuda))
    wide32 = torch.zeros((1, 256, 2, 66), device=cuda)[..., :64]
    with pytest.raises(ValueError, match="multiples of 4"):   # fp32 rows
        FA.flash_fwd_cuda(wide32, wide32, wide32, 0.125, True)
    with pytest.raises(ValueError, match="repeat GQA"):
        FA.flash_fwd_cuda(q, k[:, :, :1], v[:, :, :1], 0.125, True)
    wide = torch.zeros((1, 256, 2, 128), device=cuda).bfloat16()
    with pytest.raises(ValueError, match="strides"):   # d 64, stride 2
        FA.flash_fwd_cuda(wide[..., ::2], wide[..., ::2], wide[..., ::2],
                          0.125, True)
    lse = torch.zeros((1, 2, 256), device=cuda)
    with pytest.raises(ValueError, match="lse"):
        FA.flash_bwd_dq_cuda(q, k, v, do, lse.double(), lse, 0.125, True)
    with pytest.raises(ValueError, match="dO"):
        FA.flash_bwd_dkv_cuda(q, k, v, do.float(), lse, lse, 0.125, True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_autograd_on_the_card(cuda, dtype):
    """The kernel's forward keeps the graph: x and the weight get
    gradients, equal to the plain path's."""
    rng = np.random.default_rng(7)
    x0 = torch.tensor(rng.standard_normal((4, 33, 512)), dtype=DT[dtype],
                      device=cuda)
    w0 = torch.tensor(rng.standard_normal(512), dtype=DT[dtype], device=cuda)
    c = torch.tensor(rng.standard_normal((4, 33, 512)), dtype=torch.float32,
                     device=cuda)
    grads = []
    for plain in (False, True):
        x = x0.clone().requires_grad_(True)
        w = w0.clone().requires_grad_(True)
        reset_launch_counts()
        if plain:
            with plain_reference():
                y = rms_norm(x, w, 1e-6)
        else:
            y = rms_norm(x, w, 1e-6)
        assert launch_counts()["rms_norm"] == (0 if plain else 1)
        assert y.grad_fn is not None
        (y.float() * c).sum().backward()
        assert x.grad is not None and w.grad is not None
        grads.append((x.grad, w.grad))
    (gx, gw), (px, pw) = grads
    rtol = 2e-5 if dtype == "float32" else 2 ** -7
    torch.testing.assert_close(gx.float(), px.float(), rtol=rtol, atol=1e-5)
    torch.testing.assert_close(gw.float(), pw.float(), rtol=rtol, atol=1e-4)


def test_rms_norm_without_grad_launches_the_kernel_directly(cuda):
    """Under no_grad (serving) the router calls the wrapper without the
    autograd Function: one launch, no graph, the same values."""
    x = torch.randn((8, 4096), device=cuda).bfloat16()
    w = torch.randn((4096,), device=cuda).bfloat16().requires_grad_(True)
    reset_launch_counts()
    with torch.no_grad():
        y = rms_norm(x, w, 1e-6)
    assert launch_counts()["rms_norm"] == 1 and y.grad_fn is None
    torch.testing.assert_close(y, rms_norm_cuda(x, w.detach(), 1e-6),
                               rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d,eps", [(16384, 768, 1e-12), (1001, 768, 1e-5),
                                     (7, 96, 1e-5), (5, 4096, 1e-12),
                                     (33, 1024, 1e-5), (3, 8, 1e-5)])
def test_layer_norm_kernel_matches_plain(cuda, n, d, eps, dtype):
    rng = np.random.default_rng(n + d)
    x = torch.tensor(rng.standard_normal((n, d)) * 3 + 1, dtype=DT[dtype],
                     device=cuda)
    w = torch.tensor(rng.standard_normal(d), dtype=DT[dtype], device=cuda)
    b = torch.tensor(rng.standard_normal(d), dtype=DT[dtype], device=cuda)
    reset_launch_counts()
    got = layer_norm_cuda(x, w, b, eps)
    torch.cuda.synchronize()
    assert launch_counts() == _counts(layer_norm=1)
    want = layer_norm_plain(x, w, b, eps)
    if dtype == "float32":
        torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=1e-6,
                                   rtol=2 ** -7)


def test_layer_norm_autograd_on_the_card(cuda):
    """The kernel's forward keeps the graph: x, weight and bias get the
    plain path's gradients."""
    rng = np.random.default_rng(9)
    x0 = torch.tensor(rng.standard_normal((4, 65, 768)),
                      device=cuda).bfloat16()
    w0 = torch.tensor(rng.standard_normal(768), device=cuda).bfloat16()
    b0 = torch.tensor(rng.standard_normal(768), device=cuda).bfloat16()
    c = torch.tensor(rng.standard_normal((4, 65, 768)), dtype=torch.float32,
                     device=cuda)
    grads = []
    for plain in (False, True):
        leaves = [t.clone().requires_grad_(True) for t in (x0, w0, b0)]
        reset_launch_counts()
        with plain_reference() if plain else contextlib.nullcontext():
            y = layer_norm(*leaves, 1e-12)
        assert launch_counts()["layer_norm"] == (0 if plain else 1)
        (y.float() * c).sum().backward()
        grads.append([t.grad.float() for t in leaves])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=2 ** -7, atol=1e-4)


def test_layer_norm_raises_outside_its_gate(cuda):
    x = torch.zeros((4, 768), device=cuda).bfloat16()
    w = torch.ones(768, device=cuda).bfloat16()
    with pytest.raises(ValueError, match="dtype"):
        layer_norm_cuda(x, w.float(), w, 1e-5)
    with pytest.raises(ValueError, match="multiple of 8"):
        layer_norm_cuda(x[:, :100], w[:100], w[:100], 1e-5)
    with pytest.raises(ValueError, match="4096"):
        layer_norm_cuda(torch.zeros((2, 8192), device=cuda),
                        torch.ones(8192, device=cuda),
                        torch.ones(8192, device=cuda), 1e-5)
    with pytest.raises(ValueError, match="aligned"):
        layer_norm_cuda(x, w, torch.ones(772, device=cuda).bfloat16()[4:],
                        1e-5)
    with pytest.raises(ValueError, match="CUDA"):
        layer_norm_cuda(x, w.cpu(), w, 1e-5)


def _bias(kind, b, h, sq, sk, device, seed=0):
    """A key-padding mask as BERT's (bool [b, 1, 1, sk] converted by
    ``attn_bias``: a stride-0 view), a dense fp32 [b, h, sq, sk] bias with
    one query row that sees no key (``dense_inf``: and -inf at every 11th
    key from key 3), or an fp32 [sq, sk] bias."""
    g = torch.Generator(device=device).manual_seed(seed)
    if kind == "keypad":
        lens = torch.randint(sq // 4, sk + 1, (b,), generator=g,
                             device=device)
        keep = torch.arange(sk, device=device)[None, :] < lens[:, None]
        return FA.attn_bias(keep[:, None, None, :].expand(b, 1, sq, sk),
                            torch.empty((b, sq, h, 1)),
                            torch.empty((b, sk, h, 1)))
    dense = kind.startswith("dense")
    shape = (b, h, sq, sk) if dense else (sq, sk)
    m = torch.randn(shape, generator=g, device=device) * 2
    if kind == "dense_inf":
        m[..., 3::11] = float("-inf")
    if dense:
        m[0, -1, 7] = -1e30
    return FA.pad_bias(m, b, h, sq, sk)


@pytest.mark.parametrize("b,sq,sk,h,d,causal,kind", [
    (2, 512, 512, 12, 64, False, "keypad"),
    (2, 384, 384, 4, 64, False, "dense"),
    (2, 300, 300, 2, 128, True, "dense"),
    (1, 333, 517, 2, 64, False, "dense"),
    (1, 1000, 1000, 2, 128, True, "2d"),
    (2, 700, 1000, 2, 64, True, "2d"),
    (2, 333, 333, 2, 128, False, "keypad"),
    (1, 700, 1000, 2, 128, True, "keypad"),
    (2, 1000, 700, 2, 64, True, "dense_inf"),
    (2, 130, 130, 2, 128, False, "dense_inf"),
])
def test_flash_bias_kernels_match_plain(cuda, b, sq, sk, h, d, causal, kind):
    q, k, v, do = _flash_inputs(b, sq, sk, h, d, "bfloat16", cuda, seed=1)
    bias = _bias(kind, b, h, sq, sk, cuda)
    scale = d ** -0.5
    reset_launch_counts()
    out, lse = FA.flash_fwd_cuda(q, k, v, scale, causal, bias)
    q32, k32, v32, do32 = (x.float() for x in (q, k, v, do))
    want_o, want_l = FA.flash_fwd_plain(q32, k32, v32, scale, causal, bias)
    delta = FA.flash_delta(do, want_o.bfloat16())
    grads = (FA.flash_bwd_dq_cuda(q, k, v, do, want_l, delta, scale, causal,
                                  bias),
             *FA.flash_bwd_dkv_cuda(q, k, v, do, want_l, delta, scale,
                                    causal, bias))
    torch.cuda.synchronize()
    assert launch_counts() == _counts(flash_fwd_bias=1, flash_dq_bias=1,
                                      flash_dkv_bias=1)
    want_g = FA.flash_block_grads_plain(q32, k32, v32, do32, want_l, delta,
                                        scale, causal, bias)
    for got, want in zip((out,) + grads, (want_o,) + want_g):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        _assert_flash_close(got, want)
    dead = want_l <= -1e29
    assert torch.equal(lse <= -1e29, dead)
    assert (out.transpose(1, 2)[dead] == 0).all()
    if kind.startswith("dense"):
        assert dead[0, -1, 7]
    live_err = (lse - want_l)[~dead].abs().max().item()
    assert live_err <= 1e-4, live_err


@pytest.mark.parametrize("b,sq,sk,h,d,causal,kind", [
    (2, 1000, 1000, 3, 128, True, None),       # sq not a multiple of 128
    (2, 333, 517, 2, 64, True, None),          # causal, sk > sq
    (2, 700, 300, 2, 128, True, None),         # rows that see no key
    (1, 1, 300, 2, 64, False, None),           # one query
    (2, 300, 300, 3, 128, True, "fused"),      # views of one fused qkv
    (2, 200, 200, 2, 64, False, "fused"),
    (2, 384, 384, 4, 64, False, "dense"),      # a fully masked bias row
    (2, 1000, 700, 2, 128, True, "dense_inf"),
    (2, 130, 130, 2, 64, False, "keypad"),
])
def test_flash_bf16_forward_edges_repeat(cuda, b, sq, sk, h, d, causal,
                                         kind):
    """The bf16 forward (the wgmma kernel, plain and bias modes) at its
    edges against ``flash_fwd_plain``, and two launches bitwise equal.
    ``fused``: q, k, v as strided views of one [b, s, 3, h, d] tensor."""
    if kind == "fused":
        g = torch.Generator(device=cuda).manual_seed(4)
        q, k, v = torch.randn((b, sq, 3, h, d), generator=g,
                              device=cuda).bfloat16().unbind(2)
        assert not q.is_contiguous()
        bias = None
    else:
        q, k, v, _ = _flash_inputs(b, sq, sk, h, d, "bfloat16", cuda, seed=2)
        bias = None if kind is None else _bias(kind, b, h, sq, sk, cuda)
    scale = d ** -0.5
    reset_launch_counts()
    runs = [FA.flash_fwd_cuda(q, k, v, scale, causal, bias)
            for _ in range(2)]
    torch.cuda.synchronize()
    name = "flash_fwd" if bias is None else "flash_fwd_bias"
    assert launch_counts() == _counts(**{name: 2})
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    out, lse = runs[0]
    want_o, want_l = FA.flash_fwd_plain(q.float(), k.float(), v.float(),
                                        scale, causal, bias)
    _assert_flash_close(out, want_o)
    dead = want_l <= -1e29
    assert torch.equal(lse <= -1e29, dead)
    assert (out.transpose(1, 2)[dead] == 0).all()
    if causal and sq > sk or kind in ("dense", "dense_inf"):
        assert dead.any()
    live_err = (lse - want_l)[~dead].abs().max().item()
    assert live_err <= 1e-4, live_err


def test_flash_bf16_forward_raises_outside_its_gate(cuda):
    """The bf16 forward takes d 64 or 128 and 16-byte strides (ValueError
    from the gate), and what TMA can map: a k broadcast over the batch
    (stride 0 at size 2) passes the gate and the launch raises."""
    q, k, v, _ = _flash_inputs(2, 256, 256, 2, 64, "bfloat16", cuda)
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_fwd_cuda(*(torch.zeros((1, 256, 2, 96), device=cuda)
                            .bfloat16() for _ in range(3)), 0.1, True)
    wide = torch.zeros((2, 256, 2, 68), device=cuda).bfloat16()[..., :64]
    with pytest.raises(ValueError, match="multiples of 8"):
        FA.flash_fwd_cuda(wide, wide, wide, 0.125, True)
    kb = k[:1].expand(2, -1, -1, -1)
    assert kb.stride(0) == 0
    with pytest.raises(RuntimeError, match="CUDA error"):
        FA.flash_fwd_cuda(q, kb, v, 0.125, True)
    out, _ = FA.flash_fwd_cuda(q, k, v, 0.125, True)   # still launches
    assert torch.isfinite(out.float()).all()


@pytest.mark.parametrize("T,E,D,H,cap,act,hot", [
    (1024, 16, 128, 96, 38, "relu", False),     # cpad 40, ungated
    (1024, 16, 128, 64, 100, "silu", False),    # cpad 104
    (1024, 4, 256, 704, 1024, "silu", True),    # whole blocks empty
    (1024, 4, 128, 96, 1024, "relu", True),
])
def test_moe_bf16_forward_edges_repeat(cuda, T, E, D, H, cap, act, hot):
    """The bf16 grouped forward (the wgmma passes) at its edges against
    ``moe_fwd_plain``, and two launches bitwise equal: a capacity whose
    padded size is not a multiple of the 128-slot block, the ungated
    relu FFN, and one expert holding every token while the others hold
    none (``hot``: 128-slot blocks without a token, whose h rows the
    kernel zeroes)."""
    from paddle_tpu_torch.ops.kernels import moe_grouped_gemm as GG
    inp = _moe_inputs(cuda, T, E, D, H, seed=H + 1, capfac=cap * E / (2 * T),
                      hot=hot)
    cpad = inp["row_id"].shape[1]
    assert cpad % 128 or hot
    if hot:
        held = (inp["row_id"] < T).sum(1)
        assert held[0] == T and not held[1:].any()
    wg = inp["wg"] if act == "silu" else None
    args = (inp["x"], inp["row_id"], inp["gate_w"], inp["wi"], wg, inp["wo"])
    reset_launch_counts()
    outs = [GG.moe_fwd_cuda(*args, act) for _ in range(2)]
    torch.cuda.synchronize()
    assert launch_counts() == _counts(moe_fwd=2)
    assert torch.equal(outs[0], outs[1])
    _assert_flash_close(outs[0], GG.moe_fwd_plain(*args, act))


def test_flash_attention_mask_routes_to_the_bias_mode(cuda):
    """``flash_attention(attn_mask=bool)`` launches the bias mode of all
    three kernels once each and no no-bias mode; the mask gets no
    gradient."""
    q, k, v, _ = _flash_inputs(2, 256, 256, 2, 64, "bfloat16", cuda)
    keep = torch.ones((2, 1, 256, 256), dtype=torch.bool, device=cuda)
    keep[1, ..., 200:] = False
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    reset_launch_counts()
    out = FA.flash_attention(*leaves, attn_mask=keep)
    out.float().sum().backward()
    torch.cuda.synchronize()
    assert launch_counts() == _counts(flash_fwd_bias=1, flash_dq_bias=1,
                                      flash_dkv_bias=1)
    assert all(t.grad is not None for t in leaves)


def test_train_step_kernels_vs_plain(cuda):
    """One TrainStep from one state through the kernels and inside
    plain_reference(), bf16, b 2 x s 256 (the flash route)."""
    ids = torch.tensor(np.random.default_rng(2).integers(0, 512, (2, 256)),
                       device=cuda)
    results = []
    for plain in (False, True):
        model = _small_llama(cuda)
        step = TrainStep(model, AdamW(learning_rate=1e-3, parameters=model),
                         lambda logits, y: model.loss(logits, y))
        reset_launch_counts()
        if plain:
            with plain_reference():
                loss = step(ids, ids)
        else:
            loss = step(ids, ids)
        torch.cuda.synchronize()
        results.append((loss.item(), launch_counts(),
                        {k: p.grad.float() for k, p in
                         model.named_parameters()}))
    (lk, ck, gk), (lp, cp, gp) = results
    L = 2
    assert ck == _counts(rms_norm=2 * L + 1, flash_fwd=L, flash_dq=L,
                         flash_dkv=L)
    assert not any(cp.values())
    assert abs(lk - lp) <= 1e-2
    for k in gk:
        rel = ((gk[k] - gp[k]).norm() / gp[k].norm()).item()
        assert rel <= 5e-2, (k, rel)


def test_engine_decode_step_kernels_vs_plain(cuda):
    """One engine state after prefill, one decode step through the
    kernels and through the plain versions. fp32 model, bf16 pool: each
    layer's attention output may differ by the 1e-2 above, which the two
    layers' projections and the head carry into the logits; bound 0.05,
    and greedy tokens must agree on every decisive row."""
    torch.manual_seed(0)
    model = LlamaForCausalLM(llama_tiny(), device=cuda, seed=3)
    eng = ServingEngine(model, num_pages=64, page_size=16, max_slots=4,
                        prefill_chunk=16, max_pages_per_slot=8)
    rng = np.random.default_rng(5)
    for n in (20, 33, 47):
        eng.add_request(rng.integers(0, 512, n), 4)
    while any(r.prefilling or not r.tokens
              for r in eng.scheduler.running.values()) \
            or eng.scheduler.waiting:
        eng.step()
    reset_launch_counts()
    got = eng.decode_logits()
    counts = launch_counts()
    with plain_reference():
        want = eng.decode_logits()
    assert launch_counts() == counts   # the plain run launched nothing
    L = model.config.num_hidden_layers
    assert counts == _counts(rms_norm=2 * L + 1, paged_attention=L)
    err = (got - want).abs().max().item()
    assert err < 0.05, err
    top2 = want.topk(2, dim=-1).values
    decisive = (top2[:, 0] - top2[:, 1]) > 2 * err
    live = [s for s in eng.scheduler.running]
    agree = got.argmax(-1) == want.argmax(-1)
    assert bool(agree[live][decisive[live]].all())
    res = eng.run_to_completion(max_steps=50)
    assert all(len(t) == 4 for t in res.values())
    eng.audit_pool()


# ---------------- the int8 paged mode and int8 weights ----------------

def _int8_paged_inputs(rng, b, h, kvh, d, ps, lens, qdt, device):
    q, pk, pv, tables, seq = _paged_inputs(rng, b, h, kvh, d, ps, lens, qdt,
                                           torch.float32, device)
    ck, cv = kv_quantize(pk), kv_quantize(pv)
    return q, ck.q, cv.q, tables, seq, ck.scale, cv.scale


@pytest.mark.parametrize("qdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("g,d,ps", [(1, 128, 16), (2, 64, 8), (4, 128, 16),
                                    (4, 32, 16), (8, 128, 5)])
def test_paged_int8_kernel_matches_plain(cuda, qdt, g, d, ps):
    rng = np.random.default_rng(g * 2000 + d + ps)
    lens = [ps - 1, ps, 2 * ps, None, 300, 0, 3 * ps + 1]
    q, kq, vq, tables, seq, ks, vs = _int8_paged_inputs(
        rng, len(lens), g * 2, 2, d, ps, lens, DT[qdt], cuda)
    reset_launch_counts()
    got = paged_attention_cuda(q, kq, vq, tables, seq, k_scale=ks,
                               v_scale=vs)
    again = paged_attention_cuda(q, kq, vq, tables, seq, k_scale=ks,
                                 v_scale=vs)
    torch.cuda.synchronize()
    assert launch_counts() == _counts(paged_attention_int8=2)
    assert torch.equal(got, again)          # no atomics: bitwise repeat
    want = paged_attention_plain(q, kq, vq, tables, seq, k_scale=ks,
                                 v_scale=vs)
    assert got.dtype == want.dtype == DT[qdt]
    if qdt == "float32":
        torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
    else:
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=2 ** -15, rtol=2 ** -7)


def test_paged_int8_kernel_raises_outside_its_gate(cuda):
    rng = np.random.default_rng(1)
    q, kq, vq, tables, seq, ks, vs = _int8_paged_inputs(
        rng, 2, 4, 2, 128, 16, [5, 40], torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="need k_scale"):
        paged_attention_cuda(q, kq, vq, tables, seq)
    with pytest.raises(ValueError, match="come together"):
        paged_attention_cuda(q, kq, vq, tables, seq, k_scale=ks)
    with pytest.raises(ValueError, match="scales must be"):
        paged_attention_cuda(q, kq, vq, tables, seq, k_scale=ks.double(),
                             v_scale=vs)
    with pytest.raises(ValueError, match="scales must be"):
        paged_attention_cuda(q, kq, vq, tables, seq, k_scale=ks[..., :1],
                             v_scale=vs)
    with pytest.raises(ValueError, match="go with int8"):
        paged_attention_cuda(q, kq.bfloat16(), vq.bfloat16(), tables, seq,
                             k_scale=ks, v_scale=vs)
    with pytest.raises(ValueError, match="q must be"):
        paged_attention_cuda(q.half(), kq, vq, tables, seq, k_scale=ks,
                             v_scale=vs)


def test_int8_linear_on_the_card_matches_its_cpu_form(cuda):
    rng = np.random.default_rng(2)
    w = torch.tensor(rng.standard_normal((512, 384)), dtype=torch.float32)
    x = torch.tensor(rng.standard_normal((3, 5, 512)), dtype=torch.bfloat16)
    layer = Int8ServingLinear(*quantize_weight(w))
    want = layer(x)
    got = layer.to(cuda)(x.to(cuda))
    assert got.dtype == torch.bfloat16 and got.shape == (3, 5, 384)
    torch.testing.assert_close(got.float().cpu(), want.float(), atol=1e-6,
                               rtol=2 ** -7)


def test_int8_engine_decode_step_kernels_vs_plain(cuda):
    """The int8 pool over an int8-weight fp32 model: one decode step
    through the kernels, in the int8 mode only, and through the plain
    versions. The int8 cores differ only in the order of the sums; the
    bound is the one of the bf16-pool test above."""
    model = quantize_for_serving(
        LlamaForCausalLM(llama_tiny(), device=cuda, seed=3), inplace=True)
    eng = ServingEngine(model, num_pages=64, page_size=16, max_slots=4,
                        prefill_chunk=16, max_pages_per_slot=8,
                        kv_quant=True)
    rng = np.random.default_rng(6)
    for n in (20, 33, 47):
        eng.add_request(rng.integers(0, 512, n), 4)
    while any(r.prefilling or not r.tokens
              for r in eng.scheduler.running.values()) \
            or eng.scheduler.waiting:
        eng.step()
    reset_launch_counts()
    got = eng.decode_logits()
    counts = launch_counts()
    with plain_reference():
        want = eng.decode_logits()
    assert launch_counts() == counts
    L = model.config.num_hidden_layers
    assert counts == _counts(rms_norm=2 * L + 1, paged_attention_int8=L)
    err = (got.float() - want.float()).abs().max().item()
    assert err < 0.05, err
    res = eng.run_to_completion(max_steps=50)
    assert all(len(t) == 4 for t in res.values())
    assert eng.metrics.summary()["kv_quant_scale_max"] > 0
    eng.audit_pool()


# ---------------- the MoE kernels ----------------

def _moe_inputs(cuda, T, E, D, H, seed=0, capfac=1.25, dtype="bfloat16",
                hot=False):
    """Routing (the plain chain, random keep) and grouped-GEMM inputs:
    x, g ~ N(0, 1), weights ~ N(0, 1/K) for a product over K (so every
    product is O(1)), in ``dtype``; fp32 logits and uniforms. ``hot``:
    expert 0's logit raised by 50, so that every token's first choice is
    expert 0 and its second copy is dropped (its keep threshold ~e^-50):
    expert 0 holds every token (up to capacity), the others none."""
    from paddle_tpu_torch.distributed.moe import _slot_structures, _top2_parts
    from paddle_tpu_torch.ops.kernels import moe_grouped_gemm as GG
    g = torch.Generator(device=cuda).manual_seed(seed)
    logits = torch.randn((T, E), generator=g, device=cuda) * 1.5
    if hot:
        logits[:, 0] += 50.0
    u = torch.rand((T,), generator=g, device=cuda)
    cap = max(4, int(capfac * T * 2 / E))
    parts = _top2_parts(logits, cap, u=u)
    cpad = GG.padded_capacity(cap)
    slot, _, fill, occ = _slot_structures(
        torch.stack(parts[:2], 1), torch.stack(parts[6:8], 1),
        torch.stack(parts[4:6], 1), E, cpad)
    row_id, gate_w = GG.slot_maps(slot, fill, occ,
                                  torch.stack(parts[2:4], 1).reshape(-1),
                                  T, E, cpad, 2)

    def rand(*shape, std=1.0):
        return (torch.randn(shape, generator=g, device=cuda)
                * std).to(DT[dtype])
    return dict(logits=logits, u=u, row_id=row_id, gate_w=gate_w.detach(),
                x=rand(T, D), g=rand(T, D), wi=rand(E, D, H, std=D ** -0.5),
                wg=rand(E, D, H, std=D ** -0.5),
                wo=rand(E, H, D, std=H ** -0.5))


@pytest.mark.parametrize("random_keep2", [True, False])
@pytest.mark.parametrize("T,E", [(1024, 16), (8192, 16), (2048, 8),
                                 (1024, 128), (65536, 16), (1024, 2)])
def test_moe_routing_kernel_matches_plain(cuda, T, E, random_keep2):
    """Decisions equal wherever the row's top-2 / keep2 margin is at least
    1e-6 (two fp32 softmaxes, sums in another order); positions exactly
    the scan of the kernel's own decisions; g1, g2 to 1e-6; me_sum to
    1e-5 relative; a second launch bitwise equal. The tiled kernel at its
    edges: 4 tiles (T 1024) to 256 (T 65536), E 2 to 128."""
    from paddle_tpu_torch.ops.kernels import moe_routing as MR
    inp = _moe_inputs(cuda, T, E, 64, 64)
    logits, u = inp["logits"], inp["u"]
    reset_launch_counts()
    got = MR.moe_routing_cuda(logits, u, random_keep2)
    again = MR.moe_routing_cuda(logits, u, random_keep2)
    torch.cuda.synchronize()
    assert launch_counts() == _counts(moe_routing=2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = MR.routing_plain(logits, u, random_keep2)
    differ = ((got[0] != want[0]) | (got[1] != want[1])
              | (got[6] != want[6]))
    p = torch.softmax(logits, -1).topk(min(3, E), -1).values
    thr = 2 * p[:, 1] / (p[:, 0] + p[:, 1])
    margin = torch.stack([p[:, 0] - p[:, 1],      # E 2: no third expert
                          p[:, 1] - p[:, 2] if E > 2 else torch.ones_like(u),
                          (u - thr).abs() if random_keep2
                          else torch.ones_like(u)]).amin(0)
    assert bool((margin[differ] < 1e-6).all()), margin[differ]
    iota = torch.arange(E, device=cuda)
    m1 = (got[0].long()[:, None] == iota).int()
    m2 = (got[1].long()[:, None] == iota).int() * got[6][:, None]
    assert torch.equal(got[4], ((m1.cumsum(0) - 1) * m1).sum(1).int())
    assert torch.equal(got[5], ((m2.cumsum(0) - 1) * m2).sum(1).int())
    assert torch.equal(got[7], m1.sum(0).float())
    same = ~differ
    for i in (2, 3):
        assert (got[i] - want[i])[same].abs().max().item() <= 1e-6
    torch.testing.assert_close(got[8], want[8], rtol=1e-5, atol=0)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("T,E,D,H,capfac,act", [
    (1024, 4, 128, 64, 1.25, "silu"), (1024, 4, 128, 96, 1.0, "silu"),
    (2048, 8, 256, 704, 1.25, "silu"), (1024, 4, 128, 64, 0.3, "silu"),
    (1024, 4, 128, 64, 1.25, "relu"), (1024, 16, 128, 32, 0.1, "silu"),
    # capacity 129 (cpad 256): every expert fills, and its last 128-slot
    # block holds one token
    (2048, 16, 128, 64, 129 / 256, "silu"),
    (1024, 16, 256, 32, 1.25, "silu"), (1024, 16, 256, 96, 1.25, "relu")])
def test_moe_grouped_kernels_match_plain(cuda, T, E, D, H, capfac, act,
                                         dtype):
    """Forward, dX and dW (dW from the kernel's own dX intermediates)
    against the plain versions. bf16: each row within 2**-7 of its
    largest magnitude + 1e-3 and 4e-3 in relative Frobenius norm (the
    flash rule; the dW outputs are rounded to bf16, the plain ones are
    fp32). fp32 (3xTF32): each output against the plain versions in fp64
    within ``_fp32_rule`` of the plain fp32 versions. The dgw of empty
    slots is not compared; each launch repeated bitwise. ``relu`` runs
    the ungated FFN."""
    _check_grouped(cuda, T, E, D, H, capfac, act, dtype)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("act", ["silu", "relu"])
def test_moe_grouped_kernels_one_hot_expert(cuda, act, dtype):
    """The same checks with one expert holding every token and the other
    three empty (``_moe_inputs(hot=True)``, capacity 1024 = T): every
    slot block of expert 0 full, every block of the others skipped."""
    _check_grouped(cuda, 1024, 4, 128, 64, 2.0, act, dtype, hot=True)


@pytest.mark.parametrize("T,E,D,H,capfac,act,hot", [
    (1024, 4, 128, 32, 1.25, "silu", False),    # H 32: half a 64-column tile
    (1024, 4, 128, 96, 1.25, "relu", False),    # H 96, the ungated FFN
    # capacity 129 (cpad 256): every expert's last 128-slot block (and last
    # 32-slot dW chunk) holds one token
    (2048, 16, 128, 96, 129 / 256, "silu", False),
    # one expert holding all 4096 tokens at D 1024: dW's chain over 4096
    # slots, 128 chunks, each into a fresh accumulator
    (4096, 4, 1024, 64, 2.0, "silu", True),
    # H 160, D 192: the forward's last 128-column block holds one 32- (H)
    # or 64-column (D) half and one past the edge, in each pass
    (1024, 4, 192, 160, 1.25, "silu", False)])
def test_moe_fp32_tf32_ring_edges(cuda, T, E, D, H, capfac, act, hot):
    """The fp32 forward, dX and dW on TF32 wgmma (``dx_h_tf32_kernel``
    and ``dx_out_tf32_kernel`` in their FWD and dX modes,
    ``dw_tf32_kernel``) at the edges of their rings: each output against
    the plain versions in fp64 within ``_fp32_rule`` of the plain fp32
    versions, each launch repeated bitwise (``_check_grouped``)."""
    _check_grouped(cuda, T, E, D, H, capfac, act, "float32", hot=hot)


def _check_grouped(cuda, T, E, D, H, capfac, act, dtype, hot=False):
    from paddle_tpu_torch.ops.kernels import moe_grouped_gemm as GG
    inp = _moe_inputs(cuda, T, E, D, H, seed=H, capfac=capfac, dtype=dtype,
                      hot=hot)
    if hot:
        held = (inp["row_id"] < T).sum(1)
        assert held[0] == T and not held[1:].any()
    wg = inp["wg"] if act == "silu" else None
    args = (inp["x"], inp["row_id"], inp["gate_w"], inp["wi"], wg, inp["wo"])
    reset_launch_counts()
    outs = [GG.moe_fwd_cuda(*args, act) for _ in range(2)]
    dxs = [GG.moe_dx_cuda(*args, inp["g"], act) for _ in range(2)]
    dws = [GG.moe_dw_cuda(inp["x"], inp["row_id"], inp["gate_w"], inp["g"],
                          dxs[0][2]) for _ in range(2)]
    torch.cuda.synchronize()
    sfx = "_fp32" if dtype == "float32" else ""
    assert launch_counts() == _counts(**{f"moe_{n}{sfx}": 2
                                         for n in ("fwd", "dx", "dw")})
    occ = (inp["row_id"] < T).float()
    assert torch.equal(outs[0], outs[1]) and torch.equal(dxs[0][0],
                                                         dxs[1][0])
    assert torch.equal(dxs[0][1] * occ, dxs[1][1] * occ)
    assert all(a is None and b is None or torch.equal(a, b)
               for a, b in zip(dws[0], dws[1]))
    want_out = GG.moe_fwd_plain(*args, act)
    wdx, wdgw, _ = GG.moe_dx_plain(*args, inp["g"], act)
    wdw = GG.moe_dw_plain(inp["x"], inp["row_id"], inp["gate_w"], inp["g"],
                          dxs[0][2])
    pairs = [(outs[0], want_out), (dxs[0][0], wdx),
             (dxs[0][1] * occ, wdgw * occ)]
    pairs += [(a, b) for a, b in zip(dws[0], wdw) if b is not None]
    if dtype == "float32":
        a64 = (inp["x"].double(), inp["row_id"], inp["gate_w"],
               inp["wi"].double(), None if wg is None else wg.double(),
               inp["wo"].double())
        g64 = inp["g"].double()
        rdx, rdgw, _ = GG.moe_dx_plain(*a64, g64, act)
        refs = [GG.moe_fwd_plain(*a64, act), rdx, rdgw * occ]
        refs += [r for r in GG.moe_dw_plain(
            a64[0], inp["row_id"], inp["gate_w"], g64,
            tuple(None if t is None else t.double() for t in dxs[0][2]))
            if r is not None]
        for (got, plain), ref in zip(pairs, refs):
            assert got.dtype == torch.float32 and got.shape == ref.shape
            _fp32_rule(got, plain, ref)
        return
    for got, want in pairs:
        assert got.shape == want.shape
        _assert_flash_close(got, want)
    if capfac < 0.5:       # a token whose copies were all dropped: 0
        dead = ~torch.isin(torch.arange(T, device=cuda), inp["row_id"])
        assert dead.any() and (outs[0][dead] == 0).all()


def test_moe_kernels_raise_outside_their_gate(cuda):
    from paddle_tpu_torch.ops.kernels import moe_grouped_gemm as GG
    from paddle_tpu_torch.ops.kernels import moe_routing as MR
    inp = _moe_inputs(cuda, 1024, 4, 128, 64)
    args = [inp["x"], inp["row_id"], inp["gate_w"], inp["wi"], inp["wg"],
            inp["wo"]]
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        GG.moe_fwd_cuda(args[0].half(), *args[1:], "silu")
    with pytest.raises(ValueError, match="x's dtype"):
        GG.moe_fwd_cuda(*args[:3], *(w.float() for w in args[3:]), "silu")
    with pytest.raises(ValueError, match="H of 32"):
        GG.moe_fwd_cuda(*args[:3], args[3][..., :48].contiguous(),
                        args[4][..., :48].contiguous(),
                        args[5][:, :48].contiguous(), "silu")
    with pytest.raises(ValueError, match="activation"):
        GG.moe_fwd_cuda(*args, "gelu")
    with pytest.raises(ValueError, match="int32"):
        GG.moe_dx_cuda(args[0], args[1].long(), *args[2:], inp["g"], "silu")
    with pytest.raises(ValueError, match="T a multiple"):
        MR.moe_routing_cuda(inp["logits"][:1000].contiguous(), None, False)
    with pytest.raises(ValueError, match="float32"):
        MR.moe_routing_cuda(inp["logits"].bfloat16(), None, False)


def _small_moe(cuda, seed=3, dtype="bfloat16"):
    """Two sparse layers at D 128 (the fused gate needs D % 128 == 0),
    head_dim 64, E 4 x H 64, in ``dtype``; at b 2 x s 512 (T 1024) both
    MoE kernels, flash and RMSNorm run."""
    from paddle_tpu_torch.models import Qwen2MoeConfig, Qwen2MoeForCausalLM
    cfg = Qwen2MoeConfig(vocab_size=512, hidden_size=128,
                         intermediate_size=256, moe_intermediate_size=64,
                         shared_expert_intermediate_size=128,
                         num_hidden_layers=2, num_attention_heads=2,
                         num_key_value_heads=1, num_experts=4,
                         num_experts_per_tok=2, max_position_embeddings=512,
                         dtype=dtype, ep_dispatch="fused")
    return Qwen2MoeForCausalLM(cfg, device=cuda, seed=seed)


def test_moe_train_step_kernels_vs_plain(cuda):
    """One TrainStep from one state (the routers' generator reseeded)
    through the kernels and inside plain_reference(): loss 1e-2 and each
    gradient 0.15 in relative L2. Looser than the Llama step above: the
    bf16 activations of the two runs differ by an ulp here and there,
    which flips the routing of tokens near a tie (top-2 gap or keep2
    threshold within ~1e-3); a flipped token sends its gradient to other
    experts and shifts the FCFS slots after it, so the router and expert
    gradients differ by a few percent (measured on the H100: 0.067 for
    ``layers.0.mlp.moe.gate.weight``)."""
    ids = torch.tensor(np.random.default_rng(2).integers(0, 512, (2, 512)),
                       device=cuda)
    results = []
    for plain in (False, True):
        model = _small_moe(cuda)
        step = TrainStep(model, AdamW(learning_rate=1e-3, parameters=model),
                         lambda logits, y: model.loss(logits, y))
        reset_launch_counts()
        if plain:
            with plain_reference():
                loss = step(ids, ids)
        else:
            loss = step(ids, ids)
        torch.cuda.synchronize()
        results.append((loss.item(), launch_counts(),
                        {k: p.grad.float() for k, p in
                         model.named_parameters()}))
    (lk, ck, gk), (lp, cp, gp) = results
    L = 2
    assert ck == _counts(rms_norm=2 * L + 1, flash_fwd=L, flash_dq=L,
                         flash_dkv=L, moe_routing=L, moe_fwd=L, moe_dx=L,
                         moe_dw=L)
    assert not any(cp.values())
    assert abs(lk - lp) <= 1e-2
    for k in gk:
        rel = ((gk[k] - gp[k]).norm() / gp[k].norm()).item()
        assert rel <= 0.15, (k, rel)
    assert gk["layers.0.mlp.moe.gate.weight"].dtype == torch.float32


def test_moe_fp32_train_step_kernels_vs_plain(cuda):
    """One fp32 TrainStep of ``_small_moe`` from one state through the
    kernels and inside plain_reference(): every MoE launch is the fp32
    mode (and flash's), none the bf16 one; loss 1e-4 and each gradient
    1e-3 in relative L2 (``chip_smoke.FP32_PARITY``'s limits: both runs
    fp32, so no routing decision sits within their difference of a tie
    at this size, and no gradient moves to another expert)."""
    ids = torch.tensor(np.random.default_rng(2).integers(0, 512, (2, 512)),
                       device=cuda)
    results = []
    for plain in (False, True):
        model = _small_moe(cuda, dtype="float32")
        step = TrainStep(model, AdamW(learning_rate=1e-3, parameters=model),
                         lambda logits, y: model.loss(logits, y))
        reset_launch_counts()
        with plain_reference() if plain else contextlib.nullcontext():
            loss = step(ids, ids)
        torch.cuda.synchronize()
        results.append((loss.item(), launch_counts(),
                        {k: p.grad for k, p in model.named_parameters()}))
    (lk, ck, gk), (lp, cp, gp) = results
    L = 2
    assert ck == _counts(rms_norm=2 * L + 1, flash_fwd_fp32=L,
                         flash_dq_fp32=L, flash_dkv_fp32=L, moe_routing=L,
                         moe_fwd_fp32=L, moe_dx_fp32=L, moe_dw_fp32=L)
    assert not any(cp.values())
    assert abs(lk - lp) <= 1e-4
    for k in gk:
        assert gk[k].dtype == torch.float32
        rel = ((gk[k] - gp[k]).norm() / gp[k].norm()).item()
        assert rel <= 1e-3, (k, rel)


def test_bert_train_step_kernels_vs_plain(cuda):
    """One padded BERT TrainStep (bf16, hidden 256, 4 heads of 64, 2
    layers, b 2 x s 256) through the kernels and inside
    plain_reference(): the LayerNorm kernel and the bias mode of the
    three flash kernels launch, the no-bias modes do not; the loss and
    gradients within the training step's rule."""
    cfg = BertConfig(vocab_size=512, hidden_size=256, num_hidden_layers=2,
                     num_attention_heads=4, intermediate_size=512,
                     hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0, dtype="bfloat16")
    rng = np.random.default_rng(4)
    ids = torch.tensor(rng.integers(0, 512, (2, 256)), device=cuda)
    mask = torch.ones((2, 256), dtype=torch.long, device=cuda)
    mask[1, 150:] = 0
    mlm = torch.where(mask > 0, ids, -100)
    nsp = torch.tensor([0, 1], device=cuda)
    results = []
    for plain in (False, True):
        model = BertForPreTraining(cfg, device=cuda, seed=3)
        step = TrainStep(model, AdamW(learning_rate=1e-3, parameters=model),
                         lambda out, lab: model.loss(*out, *lab), n_inputs=3)
        reset_launch_counts()
        with plain_reference() if plain else contextlib.nullcontext():
            loss = step(ids, torch.zeros_like(ids), mask, (mlm, nsp))
        torch.cuda.synchronize()
        results.append((loss.item(), launch_counts(),
                        {k: p.grad.float() for k, p in
                         model.named_parameters()}))
    (lk, ck, gk), (lp, cp, gp) = results
    L = 2
    assert ck == _counts(layer_norm=2 * L + 2, flash_fwd_bias=L,
                         flash_dq_bias=L, flash_dkv_bias=L)
    assert not any(cp.values())
    assert abs(lk - lp) <= 1e-2 * max(1.0, abs(lp) / 10)
    for k in gk:
        # a key bias's exact gradient is 0 (the softmax cancels a bias
        # added to a whole score row): both runs hold rounding noise, so
        # it is held to the scale of its weight's gradient (same dK terms)
        ref = (k.replace(".bias", ".weight")
               if k.endswith("self_attn.k_proj.bias") else k)
        rel = ((gk[k] - gp[k]).norm() / gp[ref].norm().clamp(min=1e-30)
               ).item()
        assert rel <= 5e-2, (k, rel)


def _fp32_rule(got, plain, ref):
    """The fp32 kernels' rule (``chip_smoke.flash_fp32_errors``): the
    kernel's error against fp64 at most 2x the plain fp32 version's plus
    2**-16 of a row (worst row, a row's scale its largest magnitude plus
    2**-6 of the output's: the first causal rows of dq are differences of
    nearly equal terms) and 2**-18 in relative Frobenius norm."""
    def errs(x):
        diff = x.double() - ref
        scale = ref.abs().amax(-1) + 2 ** -6 * ref.abs().max()
        return ((diff.abs().amax(-1) / scale.clamp(min=1e-300)).max().item(),
                (diff.norm() / ref.norm().clamp(min=1e-300)).item())
    (kr, kf), (pr, pf) = errs(got), errs(plain)
    assert kr <= 2 * pr + 2 ** -16 and kf <= 2 * pf + 2 ** -18, (kr, pr,
                                                                  kf, pf)


def _fp32_check(q, k, v, do, scale, causal, bias=None, p=0.0, seed=None,
                seg=None):
    """fp32 kernels and plain versions against the plain versions in
    fp64, the backward from the fp64 forward's lse and delta."""
    mode = (bias, p, seed, seg)
    q64, k64, v64, do64 = (x.double() for x in (q, k, v, do))
    ro, rl = FA.flash_fwd_plain(q64, k64, v64, scale, causal, *mode)
    rd = FA.flash_delta(do64, ro)
    rg = FA.flash_block_grads_plain(q64, k64, v64, do64, rl, rd, scale,
                                    causal, *mode)
    lse, delta = rl.float(), rd.float()
    po, _ = FA.flash_fwd_plain(q, k, v, scale, causal, *mode)
    pg = FA.flash_block_grads_plain(q, k, v, do, lse, delta, scale, causal,
                                    *mode)
    ko, kl = FA.flash_fwd_cuda(q, k, v, scale, causal, *mode)
    kg = (FA.flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale, causal,
                               *mode),) + FA.flash_bwd_dkv_cuda(
        q, k, v, do, lse, delta, scale, causal, *mode)
    torch.cuda.synchronize()
    for got, plain, ref in zip((ko,) + kg, (po,) + pg, (ro,) + rg):
        assert got.dtype == torch.float32
        _fp32_rule(got, plain, ref)
    live = rl > -1e29
    assert ((kl.double() - rl)[live].abs().max().item()) <= 1e-5
    return ko, kg


def _bias_of(kind, b, h, sq, sk, q, k, device):
    if kind is None:
        return None
    if kind in ("keypad", "one_key"):
        keep = torch.ones((b, 1, 1, sk), dtype=torch.bool, device=device)
        keep[-1, ..., sk // 3 if kind == "keypad" else 1:] = False
        return FA.attn_bias(keep.expand(b, 1, sq, sk), q, k)
    g = torch.Generator(device=device).manual_seed(7)
    if kind == "head_keys":   # [b, h, 1, sk]: query stride 0, head stride not
        m = torch.randn((b, h, 1, sk), generator=g, device=device) * 2
        return FA.pad_bias(m.expand(b, h, sq, sk), b, h, sq, sk)
    m = torch.randn((b, h, sq, sk), generator=g, device=device) * 2
    if kind == "dead":     # -inf entries and a row that sees no key
        m[..., 3::11] = float("-inf")
        m[0, -1, min(7, sq - 1)] = -1e30
    return FA.pad_bias(m, b, h, sq, sk)


@pytest.mark.parametrize("b,sq,sk,h,d,causal,bias", [
    (2, 256, 256, 4, 64, True, None),
    (1, 700, 1000, 2, 128, True, None),
    (1, 1000, 700, 2, 64, True, None),
    (2, 333, 333, 3, 64, False, "keypad"),
    (1, 512, 512, 2, 128, False, "dense"),
    (2, 200, 200, 2, 128, False, "one_key"),
    (2, 200, 200, 2, 64, False, "one_key"),
])
def test_flash_fp32_kernels_against_fp64(cuda, b, sq, sk, h, d, causal,
                                         bias):
    """The fp32 mode (3xTF32 products) against fp64, within ``_fp32_rule``
    of the plain fp32 versions, ragged lengths and sq != sk included.
    ``one_key``: a key-padding mask that leaves every row of the last
    batch element one key, whose dS = P (dP - delta) is 0 in exact
    arithmetic, so its dq and that key's dk are dP's rounding alone (d
    128: the mma.sync backward; d 64: the TF32 wgmma one)."""
    q, k, v, do = _flash_inputs(b, sq, sk, h, d, "float32", cuda, seed=5)
    reset_launch_counts()
    _fp32_check(q, k, v, do, d ** -0.5, causal,
                _bias_of(bias, b, h, sq, sk, q, k, cuda))
    sfx = "_fp32" + ("_bias" if bias else "")
    assert launch_counts() == _counts(**{f"flash_{n}{sfx}": 1
                                         for n in ("fwd", "dq", "dkv")})


@pytest.mark.parametrize("bias", [None, "keypad", "dense", "dead"])
@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("b,sq,sk,h,causal,fused", [
    (8, 1, 1, 16, False, False), (2, 63, 63, 2, True, False),
    (2, 130, 130, 3, False, False), (2, 130, 130, 3, True, True),
    (2, 260, 200, 2, True, False), (1, 200, 330, 2, True, False),
    (2, 333, 333, 3, False, True)])
def test_flash_fp32_d64_tf32_backward(cuda, b, sq, sk, h, causal, fused,
                                      drop, bias):
    """fp32 at d 64 without segment ids: the TF32 wgmma dQ and dK/dV
    (``csrc/flash_bwd_tf32.cuh``) against fp64 by ``_fp32_rule``, plain
    and dropout (p 0.1, one key), without a bias and with one
    (``_bias_of``: a key-padding mask, a dense random [b, h, sq, sk] one,
    and a dense one with -inf entries and a -1e30 row, ``dead``): s 1, 63
    (a ragged ring tile), 130, sq != sk both ways (causal [260, 200]: rows
    0-59 see no key, row 60 one), and q, k, v, dO as views of one fused
    [b, s, 4, h, 64] tensor; two launches bitwise equal, and exactly one
    launch of each kernel counted in the mode's counter. At s 1 every
    row's dq and dk are 0 in exact arithmetic, so both sides' errors are
    roundings of dP - delta, whole ulps apart: 128 rows (b 8, h 16), so
    that the rule compares their spread (with 4 rows a kernel 2 ulps off
    where the plain version was 1 read as 2x)."""
    if fused:
        g = torch.Generator(device=cuda).manual_seed(9)
        q, k, v, do = torch.randn((b, sq, 4, h, 64), generator=g,
                                  device=cuda).unbind(2)
        assert not q.is_contiguous()
    else:
        q, k, v, do = _flash_inputs(b, sq, sk, h, 64, "float32", cuda,
                                    seed=9)
    seed = torch.tensor([77, 5], dtype=torch.int64, device=cuda)
    mask = _bias_of(bias, b, h, sq, sk, q, k, cuda)
    mode = (mask, 0.1, seed) if drop else (mask, 0.0, None)
    reset_launch_counts()
    _fp32_check(q, k, v, do, 0.125, causal, *mode)
    sfx = "_fp32" + ("_drop" if drop else "") + ("_bias" if bias else "")
    assert launch_counts() == _counts(**{f"flash_{n}{sfx}": 1
                                         for n in ("fwd", "dq", "dkv")})
    out, lse = FA.flash_fwd_cuda(q, k, v, 0.125, causal, *mode)
    delta = FA.flash_delta(do, out)
    first, second = ((FA.flash_bwd_dq_cuda(q, k, v, do, lse, delta, 0.125,
                                           causal, *mode),)
                     + FA.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, 0.125,
                                             causal, *mode)
                     for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("b,sq,sk,h,causal,bias", [
    (2, 300, 1, 2, False, None), (2, 600, 400, 2, True, None),
    (2, 333, 517, 3, False, "head_keys")])
def test_flash_fp32_d64_tf32_forward_edges(cuda, b, sq, sk, h, causal, bias,
                                           drop):
    """The fp32 forward at d 64 (``csrc/flash_fwd_tf32.cuh``) at the
    edges ``test_flash_fp32_d64_tf32_backward`` leaves: every one of 300
    rows sees one key (sk 1); causal [600, 400], where rows 0-199 see no
    key, so the first 128-row q tile loads no k tile and the next one's
    first consumer visits none of its block's two; ragged non-causal sq
    != sk with a [b, h, 1, sk] bias (query stride 0, head stride not);
    plain and dropout (p 0.1). Held with the backward by ``_fp32_rule``
    against fp64, the mode's counters one each, and two forward launches
    bitwise equal."""
    q, k, v, do = _flash_inputs(b, sq, sk, h, 64, "float32", cuda, seed=12)
    seed = torch.tensor([31, 7], dtype=torch.int64, device=cuda)
    mask = _bias_of(bias, b, h, sq, sk, q, k, cuda)
    mode = (mask, 0.1, seed) if drop else (mask, 0.0, None)
    reset_launch_counts()
    out, _ = _fp32_check(q, k, v, do, 0.125, causal, *mode)
    sfx = "_fp32" + ("_drop" if drop else "") + ("_bias" if bias else "")
    assert launch_counts() == _counts(**{f"flash_{n}{sfx}": 1
                                         for n in ("fwd", "dq", "dkv")})
    again, lse = FA.flash_fwd_cuda(q, k, v, 0.125, causal, *mode)
    assert torch.equal(again, out)
    if causal:   # rows that see no key
        assert bool((again[:, :sq - sk] == 0).all())
        assert bool((lse[..., :sq - sk] <= -1e29).all())


@pytest.mark.parametrize("bias", [None, "dense"])
def test_flash_fp32_d64_forward_mask_is_the_tf32_dq_mask(cuda, bias):
    """The TF32 forward's dropout mask is the TF32 dQ's for every (query,
    key), and both are ``philox.keep_mask``: with K = V = the identity
    (sk 48 <= d 64) the forward's out[q, j] is the dropped P[q, j] / l,
    and with delta 0 dQ's dq[q, j] is scale keep P dP / (1 - p), so
    either is nonzero exactly where the key is kept (P > 0 at these
    scores and bias). [2, 130] queries: two 128-row q tiles, a ragged
    32-key ring tile."""
    b, sq, sk, h, p = 2, 130, 48, 3, 0.1
    g = torch.Generator(device=cuda).manual_seed(13)
    q = torch.randn((b, sq, h, 64), generator=g, device=cuda)
    do = torch.randn((b, sq, h, 64), generator=g, device=cuda)
    eye = torch.eye(sk, 64, device=cuda)[None, :, None, :].expand(
        b, sk, h, 64).contiguous()
    seed = torch.tensor([2029, 3], dtype=torch.int64, device=cuda)
    mask = _bias_of(bias, b, h, sq, sk, q, eye, cuda)
    out, lse = FA.flash_fwd_cuda(q, eye, eye, 0.125, False, mask, p, seed)
    delta = torch.zeros((b, h, sq), device=cuda)
    dq = FA.flash_bwd_dq_cuda(q, eye, eye, do, lse, delta, 0.125, False,
                              mask, p, seed)
    want = keep_mask(seed, p, b * h, sq, sk)

    def kept(x):
        return (x[..., :sk] != 0).permute(0, 2, 1, 3).reshape(b * h, sq, sk)

    assert 0.85 < want.float().mean().item() < 0.95
    assert torch.equal(kept(out), want)
    assert torch.equal(kept(dq), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [None, "keypad", "dead"])
@pytest.mark.parametrize("shape", [(2, 320, 320, 3, 64),
                                   (1, 700, 1000, 2, 128),
                                   (2, 1000, 700, 2, 128)])
def test_flash_dropout_kernels_match_plain(cuda, dtype, bias, shape):
    """The dropout mode (p 0.1) against the plain versions on one key,
    so on one Philox mask: fp32 by the fp32 rule against fp64, bf16 by
    the bf16 rule against the fp32 plain versions; two launches on one
    key bitwise equal (the backward too); another key another output.
    d 64 and 128, ragged lengths with sq != sk both ways; causal without
    a bias, else non-causal with a key-padding bias or a dense one that
    holds -inf entries and a query row that sees no key (``dead``)."""
    b, sq, sk, h, d = shape
    p = 0.1
    q, k, v, do = _flash_inputs(b, sq, sk, h, d, dtype, cuda, seed=6)
    causal = bias is None
    scale = d ** -0.5
    seed = torch.tensor([2024, (1 << 32) - 7], dtype=torch.int64,
                        device=cuda)
    mask = _bias_of(bias, b, h, sq, sk, q, k, cuda)
    mode = (mask, p, seed)
    reset_launch_counts()
    if dtype == "float32":
        out, grads = _fp32_check(q, k, v, do, scale, causal, *mode)
    else:
        q32, k32, v32, do32 = (x.float() for x in (q, k, v, do))
        want_o, want_l = FA.flash_fwd_plain(q32, k32, v32, scale, causal,
                                            *mode)
        delta = FA.flash_delta(do, want_o.bfloat16())
        out, _ = FA.flash_fwd_cuda(q, k, v, scale, causal, *mode)
        grads = (FA.flash_bwd_dq_cuda(q, k, v, do, want_l, delta, scale,
                                      causal, *mode),) + \
            FA.flash_bwd_dkv_cuda(q, k, v, do, want_l, delta, scale,
                                  causal, *mode)
        want_g = FA.flash_block_grads_plain(q32, k32, v32, do32, want_l,
                                            delta, scale, causal, *mode)
        for got, want in zip((out,) + grads, (want_o,) + want_g):
            _assert_flash_close(got, want)
    sfx = ("_fp32" if dtype == "float32" else "") + "_drop" + (
        "_bias" if bias else "")
    assert launch_counts() == _counts(**{f"flash_{n}{sfx}": 1
                                         for n in ("fwd", "dq", "dkv")})
    again, lse = FA.flash_fwd_cuda(q, k, v, scale, causal, *mode)
    assert torch.equal(again, out)
    delta = FA.flash_delta(do, out)
    first, second = ((FA.flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale,
                                           causal, *mode),)
                     + FA.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, scale,
                                             causal, *mode)
                     for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(first, second))
    other, _ = FA.flash_fwd_cuda(q, k, v, scale, causal, mask, p,
                                 seed + 1)
    assert not torch.equal(other, out)


def test_gpt_train_step_kernels_vs_plain(cuda):
    """One TrainStep of a small GPT at GPT-2's defaults (fp32, dropout
    0.1; hidden 256, 4 heads of 64, 2 layers, b 2 x s 256) through the
    kernels and inside plain_reference(), the model's generator restored
    to one state, so both draw the same masks: the fp32 dropout flash
    kernels and LayerNorm launch; the loss within 1e-5 relative, every
    gradient within 1e-3 in relative L2 (fp32 kernels as accurate as the
    plain versions; GPT's key bias, whose exact gradient is 0, held to
    its weight's gradient's scale)."""
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    cfg = GPTConfig(vocab_size=512, hidden_size=256, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=512,
                    max_position_embeddings=256, mp_axis=None)
    ids = torch.tensor(np.random.default_rng(8).integers(0, 512, (2, 256)),
                       device=cuda)
    results = []
    for plain in (False, True):
        model = GPTForCausalLM(cfg, device=cuda, seed=3)
        step = TrainStep(model, AdamW(learning_rate=1e-3, parameters=model),
                         lambda logits, y: model.loss(logits, y))
        reset_launch_counts()
        with plain_reference() if plain else contextlib.nullcontext():
            loss = step(ids, ids)
        torch.cuda.synchronize()
        results.append((loss.item(), launch_counts(),
                        {k: p.grad for k, p in model.named_parameters()}))
    (lk, ck, gk), (lp, cp, gp) = results
    L = 2
    assert ck == _counts(layer_norm=2 * L + 1, flash_fwd_fp32_drop=L,
                         flash_dq_fp32_drop=L, flash_dkv_fp32_drop=L)
    assert not any(cp.values())
    assert abs(lk - lp) <= 1e-5 * abs(lp)
    for k in gk:
        ref = k.replace(".bias", ".weight") if k.endswith("attn_qkv.bias") \
            else k
        rel = ((gk[k] - gp[k]).norm() / gp[ref].norm().clamp(min=1e-30)
               ).item()
        assert rel <= 1e-3, (k, rel)


def test_entry_config_forward_on_the_card(cuda):
    """``entry()``'s fp32 Llama ([2, 256], 8 / 4 heads of 64) forward in
    eval mode: 4 fp32 flash-forward launches, logits within 1e-4 of
    plain_reference()'s."""
    cfg = LlamaConfig(vocab_size=8192, hidden_size=512,
                      intermediate_size=1408, num_hidden_layers=4,
                      num_attention_heads=8, num_key_value_heads=4,
                      max_position_embeddings=2048, mp_axis=None,
                      fsdp_axis=None)
    model = LlamaForCausalLM(cfg, device=cuda, seed=0)
    model.eval()
    ids = torch.tensor(np.random.default_rng(0).integers(0, 8192, (2, 256)),
                       device=cuda)
    reset_launch_counts()
    with torch.no_grad():
        logits = model(ids)
        torch.cuda.synchronize()
        assert launch_counts() == _counts(flash_fwd_fp32=4, rms_norm=9)
        with plain_reference():
            ref = model(ids)
    assert logits.dtype == torch.float32
    assert (logits - ref).abs().max().item() <= 1e-4


def _seg_case(kind):
    """(ids of the queries, ids of the keys) of one segment pattern."""
    def packed(lens):
        return np.repeat(np.arange(len(lens)), lens)
    if kind == "packed":      # boundaries inside tiles, a 1-token segment
        return packed((100, 37, 250, 1, 90)), packed((100, 37, 250, 1, 90))
    if kind == "touching":    # tiles whose id ranges touch at one id
        lens = (64, 64, 63, 65, 1, 127, 32)
        return packed(lens), packed(lens)
    if kind == "unsorted":    # ids that repeat: tile ranges overlap
        return (np.arange(333) // 40) % 4, (np.arange(333) // 40) % 4
    # cross attention: cu_q != cu_k, key segment 1 empty
    return packed((120, 64, 200, 33)), packed((90, 0, 150, 70))


@pytest.mark.parametrize("kind,dtype,d,causal", [
    ("packed", "bfloat16", 128, True), ("packed", "float32", 64, True),
    ("packed", "bfloat16", 64, False), ("touching", "bfloat16", 128, True),
    ("touching", "float32", 128, False), ("unsorted", "bfloat16", 64, False),
    ("unsorted", "float32", 128, True), ("cross", "bfloat16", 128, False),
    ("cross", "float32", 64, False)])
def test_flash_seg_kernels_match_plain(cuda, kind, dtype, d, causal):
    """The segment mode of the forward, dQ and dK/dV against the plain
    versions given the same ids: bf16 by the bf16 flash rule against the
    fp32 plain versions, fp32 by the fp32 rule against fp64; queries that
    see no key (the empty key segment) exact: out 0, lse -1e30, dq 0."""
    ids_q, ids_k = _seg_case(kind)
    b, h = 2, 2
    q, k, v, do = _flash_inputs(b, len(ids_q), len(ids_k), h, d, dtype,
                                cuda, seed=8)
    seg = FA.seg_ids(ids_q, ids_k, cuda)
    scale = d ** -0.5
    reset_launch_counts()
    if dtype == "float32":
        out, (dq, _, _) = _fp32_check(q, k, v, do, scale, causal, seg=seg)
        lse = FA.flash_fwd_cuda(q, k, v, scale, causal, seg=seg)[1]
        n_fwd = 2
    else:
        out, lse = FA.flash_fwd_cuda(q, k, v, scale, causal, seg=seg)
        q32, k32, v32, do32 = (x.float() for x in (q, k, v, do))
        want_o, want_l = FA.flash_fwd_plain(q32, k32, v32, scale, causal,
                                            seg=seg)
        delta = FA.flash_delta(do, want_o.bfloat16())
        dq = FA.flash_bwd_dq_cuda(q, k, v, do, want_l, delta, scale, causal,
                                  seg=seg)
        dk, dv = FA.flash_bwd_dkv_cuda(q, k, v, do, want_l, delta, scale,
                                       causal, seg=seg)
        torch.cuda.synchronize()
        want_g = FA.flash_block_grads_plain(q32, k32, v32, do32, want_l,
                                            delta, scale, causal, seg=seg)
        for got, want in zip((out, dq, dk, dv), (want_o,) + tuple(want_g)):
            _assert_flash_close(got, want)
        live = want_l > -1e29
        assert (lse - want_l)[live].abs().max().item() <= 1e-4
        n_fwd = 1
    dead = torch.tensor(np.isin(ids_q, ids_k), device=cuda) == 0
    assert int(dead.sum()) == (64 if kind == "cross" else 0)
    assert (lse[:, :, dead] == FA.NEG).all()
    assert (out[:, dead] == 0).all() and (dq[:, dead] == 0).all()
    sfx = "_fp32_seg" if dtype == "float32" else "_seg"
    assert launch_counts() == _counts(**{f"flash_fwd{sfx}": n_fwd,
                                         f"flash_dq{sfx}": 1,
                                         f"flash_dkv{sfx}": 1})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_seg_kernels_skip_tiles_of_other_segments(cuda, dtype):
    """Segments on whole 64-row tiles (128, 192, 64 tokens): the middle
    segment's k and v (forward, dQ) and its q, dO, lse and delta (dK/dV)
    are NaN, so a kernel that read one of its tiles for another
    segment's rows would give NaN there (p = 0 times NaN); the other
    segments' outputs are finite and equal the plain versions run on
    them alone."""
    lens = (128, 192, 64)
    ids = np.repeat(np.arange(3), lens)
    s, h, d = len(ids), 2, 64
    q, k, v, do = _flash_inputs(1, s, s, h, d, dtype, cuda, seed=9)
    mid = slice(128, 320)
    seg = FA.seg_ids(ids, ids, cuda)
    keep = torch.ones(s, dtype=torch.bool, device=cuda)
    keep[mid] = False
    want_o, want_l = FA.flash_fwd_plain(q[:, keep], k[:, keep], v[:, keep],
                                        0.125, True,
                                        seg=(ids[keep.cpu().numpy()],) * 2)
    delta = FA.flash_delta(do[:, keep], want_o.to(q.dtype))
    want_g = FA.flash_block_grads_plain(q[:, keep], k[:, keep], v[:, keep],
                                        do[:, keep], want_l, delta, 0.125,
                                        True, seg=(ids[keep.cpu().numpy()],)
                                        * 2)
    nan = float("nan")
    kn, vn = k.clone(), v.clone()
    kn[:, mid], vn[:, mid] = nan, nan
    out, _ = FA.flash_fwd_cuda(q, kn, vn, 0.125, True, seg=seg)
    lse = torch.full((1, h, s), nan, device=cuda)
    dlt = torch.full((1, h, s), nan, device=cuda)
    lse[:, :, keep], dlt[:, :, keep] = want_l.float(), delta
    dq = FA.flash_bwd_dq_cuda(q, kn, vn, do, lse, dlt, 0.125, True, seg=seg)
    qn, don = q.clone(), do.clone()
    qn[:, mid], don[:, mid] = nan, nan
    dk, dv = FA.flash_bwd_dkv_cuda(qn, k, v, don, lse, dlt, 0.125, True,
                                   seg=seg)
    torch.cuda.synchronize()
    for got, want in zip((out, dq, dk, dv), (want_o,) + tuple(want_g)):
        got = got[:, keep]
        assert torch.isfinite(got).all()
        if dtype == "float32":
            torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
        else:
            _assert_flash_close(got, want.float())


def test_flash_attn_unpadded_on_the_card(cuda):
    """``flash_attn_unpadded`` forward and backward through autograd, bf16
    causal: one launch of each segment-mode kernel, bitwise the outputs of
    the wrappers called by hand on the same ids (the forward, delta of
    its bf16 output, dQ, dK/dV: the kernels are deterministic), and the
    forward within the bf16 flash rule of the plain version on fp32
    copies. (The kernels against their plain versions given the same
    delta: ``test_flash_seg_kernels_match_plain``. Against a plain
    backward whose delta comes from an unrounded output, bf16 gradients
    differ by more than that rule where P (dP - delta) cancels.)"""
    lens = (300, 64, 1, 211, 500)
    cu = np.concatenate([[0], np.cumsum(lens)])
    q, k, v, dout = (x[0] for x in _flash_inputs(1, int(cu[-1]),
                                                 int(cu[-1]), 4, 128,
                                                 "bfloat16", cuda, seed=10))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    reset_launch_counts()
    out = FA.flash_attn_unpadded(*leaves, cu, cu, causal=True)
    out.backward(dout)
    torch.cuda.synchronize()
    assert launch_counts() == _counts(flash_fwd_seg=1, flash_dq_seg=1,
                                      flash_dkv_seg=1)
    ids = np.repeat(np.arange(len(lens)), lens)
    seg = FA.seg_ids(ids, ids, cuda)
    args = (q[None], k[None], v[None])
    sc = FA._scale(q, None)     # the scale flash_attn_unpadded takes
    o, lse = FA.flash_fwd_cuda(*args, sc, True, seg=seg)
    delta = FA.flash_delta(dout[None], o)
    dq = FA.flash_bwd_dq_cuda(*args, dout[None], lse, delta, sc,
                              True, seg=seg)
    dk, dv = FA.flash_bwd_dkv_cuda(*args, dout[None], lse, delta,
                                   sc, True, seg=seg)
    torch.cuda.synchronize()
    for got, want in zip((out,) + tuple(x.grad for x in leaves),
                         (o, dq, dk, dv)):
        assert torch.equal(got, want[0])
    want_o, _ = FA.flash_fwd_plain(*(x.float() for x in args), sc,
                                   True, seg=seg)
    _assert_flash_close(out[None], want_o)
