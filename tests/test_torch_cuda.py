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
  bf16 products, sums in another order).
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
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM, llama_tiny
from paddle_tpu_torch.nn.functional import rms_norm
from paddle_tpu_torch.ops.kernels import flash_attention as FA
from paddle_tpu_torch.ops.kernels import (launch_counts,
                                          paged_attention_cuda,
                                          paged_attention_plain,
                                          plain_reference,
                                          reset_launch_counts, rms_norm_cuda,
                                          rms_norm_plain)
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.quantization import (Int8ServingLinear, kv_quantize,
                                           quantize_for_serving,
                                           quantize_weight)
from paddle_tpu_torch.serving import ServingEngine

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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        FA.flash_attention(q, k, v, attn_mask=torch.zeros(256, 256,
                                                          device=cuda))
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_fwd_cuda(*(torch.zeros((1, 256, 2, 96), device=cuda)
                            .bfloat16() for _ in range(3)), 0.1, True)
    with pytest.raises(ValueError, match="all be bfloat16"):
        FA.flash_fwd_cuda(q.half(), k.half(), v.half(), 0.125, True)
    with pytest.raises(ValueError, match="all be bfloat16"):
        FA.flash_fwd_cuda(q, k.float(), v, 0.125, True)
    with pytest.raises(ValueError, match="all be bfloat16"):   # fp32 too
        FA.flash_fwd_cuda(q.float(), k.float(), v.float(), 0.125, True)
    with pytest.raises(ValueError, match="all be bfloat16"):
        FA.flash_attention(q.float(), k.float(), v.float(), causal=True)
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

def _moe_inputs(cuda, T, E, D, H, seed=0, capfac=1.25):
    """Routing (the plain chain, random keep) and grouped-GEMM inputs:
    x, g ~ N(0, 1), weights ~ N(0, 1/K) for a product over K (so every
    product is O(1)), bf16; fp32 logits and uniforms."""
    from paddle_tpu_torch.distributed.moe import _slot_structures, _top2_parts
    from paddle_tpu_torch.ops.kernels import moe_grouped_gemm as GG
    g = torch.Generator(device=cuda).manual_seed(seed)
    logits = torch.randn((T, E), generator=g, device=cuda) * 1.5
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
                * std).bfloat16()
    return dict(logits=logits, u=u, row_id=row_id, gate_w=gate_w.detach(),
                x=rand(T, D), g=rand(T, D), wi=rand(E, D, H, std=D ** -0.5),
                wg=rand(E, D, H, std=D ** -0.5),
                wo=rand(E, H, D, std=H ** -0.5))


@pytest.mark.parametrize("random_keep2", [True, False])
@pytest.mark.parametrize("T,E", [(1024, 16), (8192, 16), (2048, 8),
                                 (1024, 128)])
def test_moe_routing_kernel_matches_plain(cuda, T, E, random_keep2):
    """Decisions equal wherever the row's top-2 / keep2 margin is at least
    1e-6 (two fp32 softmaxes, sums in another order); positions exactly
    the scan of the kernel's own decisions; g1, g2 to 1e-6; me_sum to
    1e-5 relative; a second launch bitwise equal."""
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
    p = torch.softmax(logits, -1).topk(3, -1).values
    thr = 2 * p[:, 1] / (p[:, 0] + p[:, 1])
    margin = torch.stack([p[:, 0] - p[:, 1], p[:, 1] - p[:, 2],
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


@pytest.mark.parametrize("T,E,D,H,capfac,act", [
    (1024, 4, 128, 64, 1.25, "silu"), (1024, 4, 128, 96, 1.0, "silu"),
    (2048, 8, 256, 704, 1.25, "silu"), (1024, 4, 128, 64, 0.3, "silu"),
    (1024, 4, 128, 64, 1.25, "relu"), (1024, 16, 128, 32, 0.1, "silu")])
def test_moe_grouped_kernels_match_plain(cuda, T, E, D, H, capfac, act):
    """Forward, dX and dW (dW from the kernel's own dX intermediates)
    against the plain versions: each row within 2**-7 of its largest
    magnitude + 1e-3 and 4e-3 in relative Frobenius norm (the flash rule;
    the dW outputs are rounded to bf16, the plain ones are fp32); the
    dgw of empty slots is not compared; each launch repeated bitwise.
    ``relu`` runs the ungated FFN."""
    from paddle_tpu_torch.ops.kernels import moe_grouped_gemm as GG
    inp = _moe_inputs(cuda, T, E, D, H, seed=H, capfac=capfac)
    wg = inp["wg"] if act == "silu" else None
    args = (inp["x"], inp["row_id"], inp["gate_w"], inp["wi"], wg, inp["wo"])
    reset_launch_counts()
    outs = [GG.moe_fwd_cuda(*args, act) for _ in range(2)]
    dxs = [GG.moe_dx_cuda(*args, inp["g"], act) for _ in range(2)]
    dws = [GG.moe_dw_cuda(inp["x"], inp["row_id"], inp["gate_w"], inp["g"],
                          dxs[0][2]) for _ in range(2)]
    torch.cuda.synchronize()
    assert launch_counts() == _counts(moe_fwd=2, moe_dx=2, moe_dw=2)
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
    with pytest.raises(ValueError, match="bfloat16"):
        GG.moe_fwd_cuda(args[0].float(), *args[1:], "silu")
    with pytest.raises(ValueError, match="bfloat16"):
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


def _small_moe(cuda, seed=3):
    """Two sparse layers at D 128 (the fused gate needs D % 128 == 0),
    head_dim 64, E 4 x H 64, bf16; at b 2 x s 512 (T 1024) both MoE
    kernels, flash and RMSNorm run."""
    from paddle_tpu_torch.models import Qwen2MoeConfig, Qwen2MoeForCausalLM
    cfg = Qwen2MoeConfig(vocab_size=512, hidden_size=128,
                         intermediate_size=256, moe_intermediate_size=64,
                         shared_expert_intermediate_size=128,
                         num_hidden_layers=2, num_attention_heads=2,
                         num_key_value_heads=1, num_experts=4,
                         num_experts_per_tok=2, max_position_embeddings=512,
                         dtype="bfloat16", ep_dispatch="fused")
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
