"""The port's paged decode attention (plain version, the CPU path)
against the JAX package.

- against ``paged_attention_tpu``, the Pallas kernel, in interpret mode
  on the CPU, as tests/test_serving.py runs it: fp32 pools, because the
  TPU kernel keeps q and the probabilities in fp32 while the grouped core
  (and the port's CUDA kernel) round them to the cache dtype — at fp32
  the two agree; tolerance 1e-5 (sums in another order);
- against ``paged_attention_decode``'s gather path, ``t == 1`` and
  ``t > 1`` rows, fp32 and bf16 pools: the same arithmetic. Tolerance
  fp32 1e-5; bf16 1e-2 (two bf16 ulps at ``|out| < 2``: q, the
  probabilities and the output are each rounded to bf16, and a rounding
  can flip by one ulp when the fp32 sums before it run in another
  order).

Cases: ragged ``seq_lens`` with page-boundary values (``k*ps - 1``,
``k*ps``), an inactive slot (``seq_lens`` 0, table of scratch page 0),
and g = h / kvh of 1, 2 and 4.

What the CUDA kernel's wrapper computes on the host (the tiles a chunk
and the chunk count from b, kvh and ``M * ps``, the workspace's two
parts, and the workspace kept per device and stream) is checked here; so
is the kernel's decomposition of a context into chunks of tiles of
``TILE`` positions (each chunk's max and sum of exp(s - max) running
over its tiles, combined into the context's max and sum before any
probability is rounded, partials added in chunk order), emulated in
torch against the plain version at fp32 1e-5 and bf16 1e-2 (the same
roundings of q, p and the output; sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn.functional.attention import \
    cached_prefill_attention as jax_cpa
from paddle_tpu.nn.functional.attention import \
    paged_attention_decode as jax_paged
from paddle_tpu.ops.pallas.paged_attention import paged_attention_tpu
from paddle_tpu_torch.nn.functional import (cached_prefill_attention,
                                             paged_attention_decode)
from paddle_tpu_torch.ops.kernels import launch_counts, paged_attention_plain
from paddle_tpu_torch.ops.kernels import paged_attention as PA
from paddle_tpu_torch.quantization import kv_quantize
from torch_one_thread import one_torch_thread  # noqa: F401

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, g, d, ps, t=1, kvh=2, dtype="float32"):
    rng = np.random.default_rng(seed)
    lens = [ps - 1, ps, 2 * ps + 3, None, 3 * ps]      # None: inactive
    b = len(lens)
    M = max(-(-(n + t) // ps) for n in lens if n is not None) + 1
    n_pages = b * M + 1
    perm = rng.permutation(np.arange(1, n_pages))
    tables = np.zeros((b, M), np.int32)
    seq = np.zeros(b, np.int32)
    for s, n in enumerate(lens):
        if n is not None:
            live = -(-(n + t) // ps)
            tables[s, :live] = perm[s * M:s * M + live]
            seq[s] = n

    def rnd(shape):
        a = rng.standard_normal(shape).astype(np.float32)
        return np.asarray(jnp.asarray(a, JDT[dtype]).astype(jnp.float32))
    q = rnd((b, t, g * kvh, d))
    pk, pv = rnd((n_pages, ps, kvh, d)), rnd((n_pages, ps, kvh, d))
    jax_args = (jnp.asarray(q, JDT[dtype]), jnp.asarray(pk, JDT[dtype]),
                jnp.asarray(pv, JDT[dtype]), jnp.asarray(tables),
                jnp.asarray(seq))
    torch_args = (torch.tensor(q).to(TDT[dtype]),
                  torch.tensor(pk).to(TDT[dtype]),
                  torch.tensor(pv).to(TDT[dtype]), torch.tensor(tables),
                  torch.tensor(seq))
    return jax_args, torch_args


@pytest.mark.parametrize("g,d,ps", [(1, 128, 8), (2, 128, 16),
                                    (4, 128, 8), (4, 64, 16)])
def test_plain_decode_matches_pallas_kernel(g, d, ps):
    jax_args, torch_args = _inputs(g * 100 + ps, g, d, ps)
    want = np.asarray(paged_attention_tpu(*jax_args))
    before = launch_counts()
    got = paged_attention_decode(*torch_args)
    assert launch_counts() == before   # a CPU tensor takes the plain path
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [1, 3])
@pytest.mark.parametrize("g", [1, 2, 4])
def test_decode_and_multirow_match_jax_gather_path(g, t, dtype):
    jax_args, torch_args = _inputs(g * 10 + t, g, 64, 8, t=t, dtype=dtype)
    want = np.asarray(jax_paged(*jax_args).astype(jnp.float32))
    got = paged_attention_decode(*torch_args)
    assert got.dtype == TDT[dtype] and got.shape == torch_args[0].shape
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)
    if t == 1:
        torch.testing.assert_close(got, paged_attention_plain(*torch_args),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cached_prefill_attention_matches_jax(dtype):
    """The contiguous-cache twin of the gather path: row j of q sits at
    cache position seq_lens + j and attends up to itself."""
    rng = np.random.default_rng(9)
    q = rng.standard_normal((3, 4, 4, 64)).astype(np.float32)
    kc = rng.standard_normal((3, 24, 2, 64)).astype(np.float32)
    vc = rng.standard_normal((3, 24, 2, 64)).astype(np.float32)
    seq = np.array([0, 7, 19], np.int32)
    j = [jnp.asarray(a, JDT[dtype]) for a in (q, kc, vc)]
    want = np.asarray(jax_cpa(*j, jnp.asarray(seq)).astype(jnp.float32))
    t = [torch.tensor(np.asarray(a.astype(jnp.float32))).to(TDT[dtype])
         for a in j]
    got = cached_prefill_attention(*t, torch.tensor(seq))
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("b,kvh,M,ps,tiles,chunks", [
    (8, 8, 32, 16, 1, 8),        # the serving shape: 512 chunks of 64
    (8, 8, 256, 16, 4, 16),      # the long context: 4096 tiles -> 1024
    (1, 8, 32, 16, 1, 8),
    (3, 2, 160, 1, 1, 3),
    (2, 2, 32, 5, 1, 3),
    (1, 1, 1, 1, 1, 1),
    (64, 8, 256, 16, 8, 8),      # capped at 8 tiles: 4096 chunks
    (16, 8, 128, 16, 4, 8)])
def test_chunk_shape_from_table_width(b, kvh, M, ps, tiles, chunks):
    assert PA.TILE == 64 and PA.MAX_TILES == 8
    assert PA.chunk_tiles(b, kvh, M, ps) == tiles
    assert PA.n_chunks(b, kvh, M, ps) == chunks == -(-(M * ps)
                                                     // (64 * tiles))
    # the fewest tiles that keep b * kvh * chunks at the target
    assert tiles == 8 or b * kvh * chunks <= PA.TARGET_CHUNKS
    assert tiles == 1 or b * kvh * -(-(M * ps) // (32 * tiles)) \
        > PA.TARGET_CHUNKS


@pytest.mark.parametrize("b,kvh,g,d,M,ps", [(8, 8, 4, 128, 32, 16),
                                            (8, 8, 4, 128, 256, 16),
                                            (1, 8, 4, 128, 32, 16),
                                            (3, 2, 16, 32, 160, 1)])
def test_workspace_bytes(b, kvh, g, d, M, ps):
    tiles = PA.chunk_tiles(b, kvh, M, ps)
    items = b * kvh * PA.n_chunks(b, kvh, M, ps)
    ctrl, data = PA.workspace_bytes(b, kvh, g, d, M, ps)
    # ticket + 3 pad words, two flags per chunk (statistics, partial)
    assert ctrl == 16 + 8 * items
    # per chunk and head: (max, sum), 64 * tiles scores, a d-wide partial
    assert data == items * g * (8 + 4 * 64 * tiles + 4 * d)
    if (b, M) == (8, 32):              # the serving shape: 512 chunks
        assert (ctrl, data) == (4112, 1589248)
    if (b, M) == (8, 256):             # the long context: 1024 chunks of 4
        assert (ctrl, data) == (8208, 6324224)


def test_workspace_reused_per_device_and_stream():
    dev = torch.device("cpu")
    keys = [(dev, -1), (dev, -2)]
    try:
        ctrl, data = PA._work(dev, -1, 64, 1000)
        assert ctrl.dtype == data.dtype == torch.uint8
        assert ctrl.numel() == 64 and data.numel() == 1000
        assert not ctrl.any()          # control words start zeroed
        again = PA._work(dev, -1, 32, 500)       # smaller: the same two
        assert again[0] is ctrl and again[1] is data
        other = PA._work(dev, -2, 64, 1000)      # another stream
        assert other[0] is not ctrl and other[1] is not data
        grown = PA._work(dev, -1, 64, 4000)      # data grows alone
        assert grown[0] is ctrl and grown[1].numel() == 4000
        grown2 = PA._work(dev, -1, 128, 4000)    # control grows, zeroed
        assert grown2[1] is grown[1] and grown2[0].numel() == 128
        assert not grown2[0].any()
    finally:
        for k in keys:
            PA._WORK.pop(k, None)


def _chunked(q, pk, pv, tables, seq, scale, ks=None, vs=None, tiles=1):
    """The kernel's decomposition in torch: chunks of ``tiles`` tiles of
    TILE positions; a chunk's max and sum of exp(s - max) running over
    its tiles (the sum rescaled to each new max); the context's max and
    sum from the chunks'; p rounded to the core's dtype; fp32 partials
    per chunk added in chunk order; the output rounded once."""
    b, _, h, d = q.shape
    ps, kvh = pk.shape[1], pk.shape[2]
    g = h // kvh
    M = tables.shape[1]
    S = M * ps
    rt = torch.float32 if ks is not None else pk.dtype
    out = torch.zeros((b, 1, h, d), dtype=q.dtype)
    size = PA.TILE * tiles
    for s in range(b):
        n_live = min(max(int(seq[s]) + 1, 1), S)
        rows = [int(tables[s, t // ps]) * ps + t % ps for t in range(n_live)]
        for n in range(kvh):
            kr = pk.reshape(-1, kvh, d)[rows, n].float()
            vr = pv.reshape(-1, kvh, d)[rows, n].float()
            if ks is not None:
                kr = kr * ks.reshape(-1, kvh)[rows, n][:, None]
                vr = vr * vs.reshape(-1, kvh)[rows, n][:, None]
            qg = q[s, 0, n * g:(n + 1) * g].to(rt).float()          # [g, d]
            sc = (qg @ kr.T) * scale                                  # [g, t]
            chunks = [slice(c, min(c + size, n_live))
                      for c in range(0, n_live, size)]
            m_c, l_c = [], []
            for c in chunks:
                m = torch.full((g,), -float("inf"))
                l = torch.zeros((g,))
                for t0 in range(c.start, c.stop, PA.TILE):
                    st = sc[:, t0:min(t0 + PA.TILE, c.stop)]
                    m_t = st.max(dim=1).values
                    e_t = torch.exp(st - m_t[:, None]).sum(dim=1)
                    m_new = torch.maximum(m, m_t)
                    l = l * torch.exp(m - m_new) + e_t * torch.exp(m_t - m_new)
                    m = m_new
                m_c.append(m)
                l_c.append(l)
            m_c, l_c = torch.stack(m_c), torch.stack(l_c)
            m = m_c.max(dim=0).values
            l = (l_c * torch.exp(m_c - m)).sum(dim=0)
            p = (torch.exp(sc - m[:, None]) / l[:, None]).to(rt).float()
            acc = sum(p[:, c] @ vr[c] for c in chunks)
            out[s, 0, n * g:(n + 1) * g] = acc.to(q.dtype)
    return out


@pytest.mark.parametrize("tiles", [1, 2])
@pytest.mark.parametrize("ps", [1, 5, 16])
@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8"])
def test_chunk_decomposition_matches_plain(pool, ps, tiles):
    """Live lengths at the tile edges (63, 64, 65, 128, 129 positions),
    a slot inside one tile and an inactive one, g 4 at d 32; chunks of
    one tile and of two."""
    rng = np.random.default_rng(ps * 7 + len(pool))
    b, kvh, g, d = 7, 2, 4, 32
    lens = [62, 63, 64, 127, 128, 9, None]      # seq_lens; None: inactive
    M = -(-130 // ps)
    tables = torch.zeros((b, M), dtype=torch.int32)
    seq = torch.zeros((b,), dtype=torch.int32)
    perm = torch.tensor(rng.permutation(np.arange(1, b * M + 1)),
                        dtype=torch.int32)
    for s, n in enumerate(lens):
        if n is not None:
            live = -(-(n + 1) // ps)
            tables[s, :live] = perm[s * M:s * M + live]
            seq[s] = n
    shape = (b * M + 1, ps, kvh, d)
    pk = torch.tensor(rng.standard_normal(shape), dtype=torch.float32)
    pv = torch.tensor(rng.standard_normal(shape), dtype=torch.float32)
    q = torch.tensor(rng.standard_normal((b, 1, g * kvh, d)),
                     dtype=torch.float32)
    scale = d ** -0.5
    kw = {}
    if pool == "int8":
        ck, cv = kv_quantize(pk), kv_quantize(pv)
        pk, pv = ck.q, cv.q
        kw = {"k_scale": ck.scale, "v_scale": cv.scale}
    elif pool == "bfloat16":
        pk, pv, q = pk.bfloat16(), pv.bfloat16(), q.bfloat16()
    got = _chunked(q, pk, pv, tables, seq, scale, kw.get("k_scale"),
                   kw.get("v_scale"), tiles)
    want = paged_attention_plain(q, pk, pv, tables, seq, scale, **kw)
    tol = 1e-2 if pool == "bfloat16" else 1e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
