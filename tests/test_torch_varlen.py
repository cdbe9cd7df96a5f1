"""The port's packed-sequence (varlen) slice against the JAX package, on
the CPU: the native sequence packer and row gather
(``paddle_tpu_torch.io``) and ``flash_attn_unpadded`` with its incubate
alias, whose JAX counterparts run their Pallas kernels in interpret mode
(as tests/test_fused.py::test_varlen_flash_matches_loop runs them).

- ``pack_sequences`` and ``gather_rows`` equal the JAX ones bitwise, rows
  and ``cu``, on the native (C++) path and the numpy path, including
  empty and oversize sequences and a full segment budget;
- ``flash_attn_unpadded``: the output and the q, k and v gradients of
  ``sum(out * c)`` against ``jax.grad`` of the JAX function, fp32, 2
  heads of 32, lengths (48, 96, 32), causal and not; a bf16 case; a
  non-causal cross-attention batch with ``cu_q != cu_k`` and a key
  segment of length 0 (its queries see no key: out 0 and dq 0);
- ``flash_block_grads(seg=...)`` and the plain forward's segment mode
  against the JAX ``_fwd`` / ``flash_block_grads`` with unsorted ids
  shared by two batch rows;
- the ``ValueError``s (causal with unequal lengths, totals that do not
  match, segment ids with a bias or dropout);
- the grain summaries of ``seg_ids`` (the kernels' tile skipping) against
  a brute-force search;
- the chain from the packer into the kernel (counterpart of
  tests/test_native_loader.py::test_pack_cu_seqlens_feed_varlen_flash).

Tolerances: fp32 2e-5 absolute and relative, as in
tests/test_torch_flash_attention.py (the same fp32 arithmetic in one
block instead of the online softmax over Pallas blocks: only the order
of sums differs); bf16 one bf16 ulp (``rtol = 2**-7``, ``atol =
2**-9``), both rounding the same fp32 values once.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.incubate.nn import functional as JI
from paddle_tpu.io import native_loader as JL
from paddle_tpu.ops.pallas import flash_attention as J
from paddle_tpu_torch.incubate.nn.functional import \
    variable_length_memory_efficient_attention
from paddle_tpu_torch.io import native_loader as TL
from paddle_tpu_torch.nn.functional import flash_attn_unpadded
from paddle_tpu_torch.ops.kernels import flash_attention as T
from paddle_tpu_torch.ops.kernels import launch_counts
from torch_one_thread import one_torch_thread  # noqa: F401

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _close(got, want, dtype="float32"):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -9)


def _arrays(seed, shapes, dtype="float32"):
    """Arrays exactly representable in ``dtype``, as (jax, torch) pairs."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in shapes:
        a = rng.standard_normal(shape).astype(np.float32)
        a = np.asarray(jnp.asarray(a, JDT[dtype]).astype(jnp.float32))
        out.append((jnp.asarray(a, JDT[dtype]),
                    torch.tensor(a).to(TDT[dtype])))
    return out


def _seqs(seed, n=50, max_len=37):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 1000, rng.integers(1, max_len)).astype(np.int32)
            for _ in range(n)]


PACK_CASES = [  # (seed, row_len, max_segments_per_row, extra sequences)
    (0, 64, 64, []),
    (1, 48, 3, []),                                   # segment budget hit
    (2, 40, 64, [np.zeros(0, np.int32), np.arange(1, 90, dtype=np.int32)]),
]


def test_native_packer_builds():
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler: the numpy path is the contract")
    assert TL.native_available()
    assert TL.BUILD_DIR.name == "native" and TL.BUILD_DIR.parent.name \
        == "build"


@pytest.mark.parametrize("force_numpy", [False, True])
@pytest.mark.parametrize("seed,row_len,max_seg,extra", PACK_CASES)
def test_pack_sequences_matches_jax(seed, row_len, max_seg, extra,
                                    force_numpy):
    seqs = _seqs(seed) + extra
    got_rows, got_cu = TL.pack_sequences(seqs, row_len, pad_id=7,
                                         max_segments_per_row=max_seg,
                                         force_numpy=force_numpy)
    want_rows, want_cu = JL.pack_sequences(seqs, row_len, pad_id=7,
                                           max_segments_per_row=max_seg,
                                           force_numpy=force_numpy)
    assert got_rows.dtype == want_rows.dtype == np.int32
    assert got_cu.dtype == want_cu.dtype == np.int64
    np.testing.assert_array_equal(got_rows, want_rows)
    np.testing.assert_array_equal(got_cu, want_cu)
    # the two paths of the port agree too
    other = TL.pack_sequences(seqs, row_len, pad_id=7,
                              max_segments_per_row=max_seg,
                              force_numpy=not force_numpy)
    np.testing.assert_array_equal(other[0], got_rows)
    np.testing.assert_array_equal(other[1], got_cu)


@pytest.mark.parametrize("force_numpy", [False, True])
def test_gather_rows_matches_jax(force_numpy):
    rng = np.random.default_rng(4)
    corpus = rng.integers(0, 100, (128, 16)).astype(np.int32)
    idx = rng.integers(0, 128, 40)
    for n_threads in (1, 4):
        got = TL.gather_rows(corpus, idx, 16, n_threads=n_threads,
                             force_numpy=force_numpy)
        want = JL.gather_rows(corpus, idx, 16, n_threads=n_threads,
                              force_numpy=force_numpy)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, corpus[idx])
    with pytest.raises(IndexError, match="out of range"):
        TL.gather_rows(corpus, [0, 128], 16, force_numpy=force_numpy)


def _unpadded_case(seed, cu_q, cu_k, causal, dtype):
    """The port's flash_attn_unpadded and the JAX one on the same packed
    inputs: outputs and the gradients of sum(out * c)."""
    tq_, tk_ = int(cu_q[-1]), int(cu_k[-1])
    h, d = 2, 32
    (jq, tq), (jk, tk), (jv, tv), (jc, tc) = _arrays(
        seed, [(tq_, h, d), (tk_, h, d), (tk_, h, d), (tq_, h, d)], dtype)

    def jloss(q, k, v):
        out = J.flash_attn_unpadded(q, k, v, cu_q, cu_k, causal=causal)
        return jnp.sum(out.astype(jnp.float32) * jc.astype(jnp.float32)), out

    (jval, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                              has_aux=True)(jq, jk, jv)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    before = launch_counts()
    out = flash_attn_unpadded(*leaves, cu_q, cu_k, causal=causal)
    (out.float() * tc.float()).sum().backward()
    assert launch_counts() == before      # CPU tensors launch nothing
    assert out.shape == (tq_, h, d) and out.dtype == TDT[dtype]
    _close(out, jout, dtype)
    for leaf, want in zip(leaves, jgrads):
        assert leaf.grad.shape == leaf.shape
        _close(leaf.grad, want, dtype)
    return out, leaves


@pytest.mark.parametrize("causal,dtype", [(False, "float32"),
                                          (True, "float32"),
                                          (True, "bfloat16")])
def test_flash_attn_unpadded_matches_jax(causal, dtype):
    cu = np.concatenate([[0], np.cumsum([48, 96, 32])])
    _unpadded_case(11 + causal, cu, cu, causal, dtype)


def test_flash_attn_unpadded_cross_with_an_empty_key_segment():
    """Non-causal, cu_q != cu_k, key segment 1 empty: its queries see no
    key (out 0, dq 0), as in the JAX kernel."""
    cu_q = np.array([0, 40, 72, 120])
    cu_k = np.array([0, 50, 50, 130])
    out, leaves = _unpadded_case(13, cu_q, cu_k, False, "float32")
    assert (out[40:72] == 0).all()
    assert (leaves[0].grad[40:72] == 0).all()
    # cu_seqlens given as tensors take the same path
    got = flash_attn_unpadded(*(t.detach() for t in leaves),
                              torch.tensor(cu_q), torch.tensor(cu_k))
    torch.testing.assert_close(got, out.detach(), rtol=0, atol=0)


def test_variable_length_memory_efficient_attention_matches_jax():
    cu = np.concatenate([[0], np.cumsum([33, 64, 20])])
    (jq, tq), (jk, tk), (jv, tv) = _arrays(17, [(117, 2, 32)] * 3)
    for causal in (False, True):
        want = JI.variable_length_memory_efficient_attention(
            jq, jk, jv, cu, cu, causal=causal, scale=0.2)
        got = variable_length_memory_efficient_attention(
            tq, tk, tv, cu, cu, causal=causal, scale=0.2)
        _close(got, want)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_block_grads_seg_matches_jax(causal):
    """Unsorted ids shared by two batch rows (the JAX kernel broadcasts
    them over batch and heads): the plain forward against ``_fwd`` and
    ``flash_block_grads(seg=)`` against the JAX one, from the same lse
    and delta."""
    b, s, h, d = 2, 96, 2, 32
    seg_q = (np.arange(s) // 20) % 3
    seg_k = (np.arange(s) // 12) % 3
    seg_k[:5] = 7                    # keys no query sees: dk = dv = 0
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = _arrays(
        19 + causal, [(b, s, h, d)] * 4)
    scale = d ** -0.5
    jo, jl = J._fwd(jq, jk, jv, scale, causal, seg=(seg_q, seg_k))
    to, tl = T.flash_fwd_plain(tq, tk, tv, scale, causal, seg=(seg_q, seg_k))
    _close(to, jo)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-5,
                               atol=2e-5)
    delta = T.flash_delta(tdo, to)
    jg = J.flash_block_grads(jq, jk, jv, jdo, jl, jnp.asarray(delta.numpy()),
                             scale=scale, causal=causal, seg=(seg_q, seg_k))
    tg = T.flash_block_grads(tq, tk, tv, tdo, torch.tensor(np.asarray(jl)),
                             delta, scale=scale, causal=causal,
                             seg=(seg_q, seg_k))
    for got, want in zip(tg, jg):
        _close(got, want)
    assert (tg[1][:, :5] == 0).all() and (tg[2][:, :5] == 0).all()
    # a SegIds gives the same as the (seg_q, seg_k) pair
    tg2 = T.flash_block_grads(tq, tk, tv, tdo, torch.tensor(np.asarray(jl)),
                              delta, scale=scale, causal=causal,
                              seg=T.seg_ids(seg_q, seg_k))
    for a, b_ in zip(tg, tg2):
        torch.testing.assert_close(a, b_, rtol=0, atol=0)


def test_varlen_errors():
    q = torch.zeros((20, 2, 32))
    with pytest.raises(ValueError, match="seqlen_q == seqlen_k"):
        flash_attn_unpadded(q, q, q, [0, 5, 20], [0, 10, 20], causal=True)
    with pytest.raises(ValueError, match="totals"):
        flash_attn_unpadded(q, q, q, [0, 5, 19], [0, 5, 19])
    with pytest.raises(ValueError, match="totals"):
        flash_attn_unpadded(q, q[:18], q[:18], [0, 5, 20], [0, 5, 20])
    # the JAX function raises the same
    jq = jnp.zeros((20, 2, 32))
    with pytest.raises(ValueError, match="seqlen_q == seqlen_k"):
        J.flash_attn_unpadded(jq, jq, jq, [0, 5, 20], [0, 10, 20],
                              causal=True)
    x = torch.zeros((1, 20, 2, 64))
    lse = torch.zeros((1, 2, 20))
    seg = (np.zeros(20), np.zeros(20))
    with pytest.raises(ValueError, match="segment ids with a bias or with "
                                         "dropout"):
        T.flash_block_grads(x, x, x, x, lse, lse, scale=0.125, causal=False,
                            seg=seg, bias=torch.zeros((20, 20)))
    with pytest.raises(ValueError, match="segment ids with a bias or with "
                                         "dropout"):
        T.flash_block_grads(x, x, x, x, lse, lse, scale=0.125, causal=False,
                            seg=seg, dropout_p=0.1, seed_arr=(1, 2))


def _brute_meet(ids_a, ids_b):
    g = T.SEG_GRAIN
    ra = [(ids_a[i:i + g].min(), ids_a[i:i + g].max())
          for i in range(0, len(ids_a), g)]
    rb = [(ids_b[i:i + g].min(), ids_b[i:i + g].max())
          for i in range(0, len(ids_b), g)]
    return ra, np.array([[a[0] <= b[1] and b[0] <= a[1] for b in rb]
                         for a in ra]).reshape(len(ra), len(rb))


@pytest.mark.parametrize("kind", ["sorted", "random", "blocks"])
def test_seg_ids_grain_summaries(kind):
    """Each grain's (min, max) and its [first, end) window hold every
    grain of the other side that shares an id (so the kernels' skipping
    drops no kept pair); for sorted ids the window is exactly the live
    grains."""
    rng = np.random.default_rng({"sorted": 0, "random": 1, "blocks": 2}[kind])
    for _ in range(40):
        sq, sk = rng.integers(1, 300, 2)
        if kind == "sorted":
            iq, ik = (np.sort(rng.integers(0, 6, n)) for n in (sq, sk))
        elif kind == "random":
            iq, ik = (rng.integers(0, 4, n) for n in (sq, sk))
        else:
            iq, ik = ((np.arange(n) // rng.integers(1, 80)) % 3
                      for n in (sq, sk))
        s = T.seg_ids(iq, ik)
        for ids_a, ids_b, info in ((iq, ik, s.q_info), (ik, iq, s.k_info)):
            ra, meet = _brute_meet(ids_a, ids_b)
            info = info.numpy()
            assert [tuple(r) for r in info[:, :2]] == \
                [(int(a), int(b)) for a, b in ra]
            for g, row in enumerate(meet):
                live = np.nonzero(row)[0]
                if not len(live):       # no grain of the other side meets
                    continue
                assert info[g, 2] <= live.min() and info[g, 3] > live.max()
                if kind == "sorted":
                    assert (info[g, 2], info[g, 3]) == (live.min(),
                                                        live.max() + 1)


def test_packer_feeds_varlen_attention():
    """The packer's per-row segment bounds are the cu_seqlens of
    flash_attn_unpadded; the output equals the JAX kernel's on the same
    packed row."""
    rng = np.random.default_rng(23)
    seqs = [rng.integers(1, 50, n).astype(np.int32) for n in (12, 20, 9)]
    rows, cu = TL.pack_sequences(seqs, 48)
    assert rows.shape[0] == 1
    bounds = cu[0][cu[0] >= 0]
    np.testing.assert_array_equal(bounds, [0, 12, 32, 41])
    total = int(bounds[-1])
    (jq, tq), = _arrays(29, [(total, 2, 16)])
    out = flash_attn_unpadded(tq, tq, tq, bounds, bounds, causal=True)
    assert out.shape == (total, 2, 16)
    assert torch.isfinite(out).all()
    _close(out, J.flash_attn_unpadded(jq, jq, jq, bounds, bounds,
                                      causal=True))
