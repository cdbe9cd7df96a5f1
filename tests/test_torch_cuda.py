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
from paddle_tpu_torch.serving import ServingEngine

pytestmark = pytest.mark.cuda

DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
    assert launch_counts() == {"rms_norm": 2 * L + 1, "paged_attention": 0,
                               "flash_fwd": L, "flash_dq": 0, "flash_dkv": 0}
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
    assert launch_counts() == {"rms_norm": 0, "paged_attention": 0,
                               "flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1}
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
    assert ck == {"rms_norm": 2 * L + 1, "paged_attention": 0,
                  "flash_fwd": L, "flash_dq": L, "flash_dkv": L}
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
    assert counts == {"rms_norm": 2 * L + 1, "paged_attention": L,
                      "flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
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
