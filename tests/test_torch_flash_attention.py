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
- the bias mode: ``flash_fwd_plain(bias=)`` against ``_fwd(bias=)`` and
  ``flash_block_grads_plain(bias=)`` against ``flash_block_grads(bias=)``
  for a bool key-padding mask ``[b, 1, 1, sk]`` broadcast (as BERT's),
  float ``[sq, sk]``, ``[b, sq, sk]`` (per batch) and ``[b, h, sq, sk]``
  masks (the last with a fully masked query row: out 0, lse -1e30), at s
  256 and 320, fp32 and bf16, causal and not; ``flash_attention(
  attn_mask=)`` autograd against ``jax.grad``, the mask getting no
  gradient;
- the routing of ``scaled_dot_product_attention``, with and without a
  mask, below and above ``FLASH_MIN_SEQ`` (an all-masked row: uniform on
  the plain core, zero on flash, both as in the JAX package), and a float
  mask that wants a gradient taking the plain core;
- fp32 at head dim 128 (the kernels' second width), causal with sq !=
  sk and with a float bias: the plain versions and autograd against the
  JAX kernels;
- in-kernel dropout (``_flash_drop``, ``_flash_bias_drop``). The JAX
  kernels draw their mask from the TPU core's PRNG, which interpret mode
  cannot run (``flash_attention`` raises there), and their bits are not
  reproducible off a TPU anyway. So the port's plain versions, and
  autograd through ``flash_attention(dropout_p=)``, are held to an fp64
  autograd composition ``softmax(q k^T * scale + bias) * keep / (1 - p)
  @ v`` built from the same Philox mask (``philox.keep_mask``), at fp32
  tolerance; ``p = 0`` equals the no-dropout mode bitwise; one key gives
  the same output twice, another key another output; the key drawn from
  a generator follows the generator's state;
- the mode combinations the kernels do not have (segment ids with a
  bias or dropout, which no path uses), and the wrappers of every mode
  raising on CPU tensors (the segment mode itself: test_torch_varlen.py).

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

from paddle_tpu.nn.functional import attention as jattn
from paddle_tpu.ops.pallas import flash_attention as J
from paddle_tpu_torch.nn.functional import scaled_dot_product_attention
from paddle_tpu_torch.nn.functional.attention import (FLASH_MIN_SEQ,
                                                      _plain_attention)
from paddle_tpu_torch.ops.kernels import (flash_bwd_dkv_cuda,
                                          flash_bwd_dq_cuda, flash_delta,
                                          flash_fwd_cuda, launch_counts)
from paddle_tpu_torch.ops.kernels import flash_attention as T
from paddle_tpu_torch.ops.kernels.philox import keep_mask
from torch_one_thread import one_torch_thread  # noqa: F401

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


def _masks(kind, b, h, sq, sk, seed):
    """(raw mask for the JAX side, raw mask for the port) of one kind;
    bool masks keep where True."""
    rng = np.random.default_rng(seed)
    if kind == "bool_keypad":            # BERT's, broadcast over q
        keep = np.ones((b, 1, 1, sk), bool)
        keep[0, ..., sk - 100:] = False
        keep[-1, ..., 37:90] = False
        full = np.broadcast_to(keep, (b, 1, sq, sk))
        return full, torch.tensor(keep).expand(b, 1, sq, sk)
    shape = {"float_2d": (sq, sk), "float_3d": (b, sq, sk),
             "float_4d": (b, h, sq, sk)}[kind]
    m = (rng.standard_normal(shape) * 2).astype(np.float32)
    if kind == "float_4d":
        m[0, 1, 7, :] = -1e30            # a query row that sees no key
    return m, torch.tensor(m)


BIAS_CASES = [(s, kind, dtype, causal)
              for s in (256, 320)
              for kind in ("bool_keypad", "float_2d", "float_3d", "float_4d")
              for dtype, causal in (("float32", False), ("bfloat16", True))]
BIAS_CASES += [(320, "float_4d", "float32", True),
               (256, "bool_keypad", "bfloat16", False)]


@pytest.mark.parametrize("s,kind,dtype,causal", BIAS_CASES)
def test_flash_bias_plain_versions_match_pallas(s, kind, dtype, causal):
    b, h, d = 2, 2, 64
    scale = d ** -0.5
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = _inputs(
        s + len(kind), [(b, s, h, d)] * 4, dtype)
    jm, tm = _masks(kind, b, h, s, s, s)
    if jm.dtype == bool:     # flash_attention's conversion (:731-736)
        jm = np.where(jm, np.float32(0), np.float32(-1e30))
    tbias = T.attn_bias(tm, tq, tk)
    assert tbias.dtype == torch.float32 and tbias.dim() == 4
    if kind == "bool_keypad":   # converted once, still a broadcast view
        assert tbias.stride(2) == 0
    before = launch_counts()
    to, tl = T.flash_fwd_plain(tq, tk, tv, scale, causal, tbias)
    delta = flash_delta(tdo, to)

    def run(q, k, v, do, delta, m):
        o, lse = J._fwd(q, k, v, scale, causal, bias=m)
        return (o, lse) + tuple(J.flash_block_grads(
            q, k, v, do, lse, delta, scale=scale, causal=causal, bias=m))

    jo, jl, *jg = jax.jit(run)(jq, jk, jv, jdo, jnp.asarray(delta.numpy()),
                               jnp.asarray(jm))
    _close(to, jo, dtype)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-5,
                               atol=2e-5)
    if kind == "float_4d":    # the masked row: out 0, lse -1e30, no grads
        assert (tl[0, 1, 7] == T.NEG).all() and (to[0, 7, 1] == 0).all()
    lse = torch.tensor(np.asarray(jl))
    tg = T.flash_block_grads(tq, tk, tv, tdo, lse, delta, scale=scale,
                             causal=causal, bias=tbias)
    for got, want, ref in zip(tg, jg, (tq, tk, tv)):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        _close(got, want, dtype)
    if kind == "float_4d":
        assert (tg[0][0, 7, 1] == 0).all()
    assert launch_counts() == before   # CPU tensors launch nothing


@pytest.mark.parametrize("causal", [False, True])
def test_flash_bias_autograd_matches_jax_grad(causal):
    """d(sum(out * c)) through ``flash_attention(attn_mask=)`` and the
    JAX custom_vjp, fp32, s 320, a bool key-padding mask (passed to the
    port as a stride-0 view) and a float [b, h, sq, sk] one; the mask
    gets no gradient in either."""
    b, s, h, d = 2, 320, 2, 64
    (jq, tq), (jk, tk), (jv, tv), (jc, tc) = _inputs(
        11 + causal, [(b, s, h, d)] * 4, "float32")
    for kind in ("bool_keypad", "float_4d"):
        jm, tm = _masks(kind, b, h, s, s, 5)

        def jloss(q, k, v, m):
            return jnp.sum(J.flash_attention(q, k, v, causal=causal,
                                             attn_mask=m) * jc)

        jm = jnp.asarray(jm)
        argnums = (0, 1, 2) if kind == "bool_keypad" else (0, 1, 2, 3)
        jval, jgrads = jax.value_and_grad(jloss, argnums=argnums)(
            jq, jk, jv, jm)
        leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
        if tm.dtype != torch.bool:
            tm = tm.clone().requires_grad_(True)
        out = T.flash_attention(*leaves, causal=causal, attn_mask=tm)
        tval = (out * tc).sum()
        tval.backward()
        np.testing.assert_allclose(tval.item(), float(jval), rtol=2e-5)
        for leaf, want in zip(leaves, jgrads):
            _close(leaf.grad, want, "float32")
        if tm.dtype != torch.bool:   # non-differentiable in both
            assert tm.grad is None
            assert not np.asarray(jgrads[3]).any()


@pytest.fixture
def jax_flash_route(monkeypatch):
    """JAX's attention with its flash route switched on (Pallas in
    interpret mode); the list counts the calls that took it."""
    monkeypatch.setattr(jattn, "_flash_backend_ok", lambda: True)
    calls, orig = [], jattn._flash_sharded
    monkeypatch.setattr(jattn, "_flash_sharded",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    return calls


@pytest.mark.parametrize("s", [FLASH_MIN_SEQ - 128, FLASH_MIN_SEQ])
def test_sdpa_masks_route_as_jax(jax_flash_route, s):
    """A bool key-padding mask whose last batch row masks every key: the
    plain core (s < 256) gives that row the uniform average of v, flash
    (s >= 256) gives 0, in both packages; the other rows agree with JAX
    at 2e-5. A float [sq, sk] mask too."""
    b, h, d = 2, 2, 64
    (jq, tq), (jk, tk), (jv, tv) = _inputs(s, [(b, s, h, d)] * 3, "float32")
    keep = np.ones((b, 1, 1, s), bool)
    keep[0, ..., s // 2:] = False
    keep[1] = False
    got = scaled_dot_product_attention(tq, tk, tv, attn_mask=torch.tensor(
        keep))
    want = jattn.scaled_dot_product_attention(jq, jk, jv,
                                              attn_mask=jnp.asarray(keep))
    _close(got, want, "float32")
    assert len(jax_flash_route) == (s >= FLASH_MIN_SEQ)
    if s >= FLASH_MIN_SEQ:
        assert (got[1] == 0).all()
    else:
        torch.testing.assert_close(got[1], tv[1].mean(0, keepdim=True)
                                   .expand_as(got[1]), rtol=1e-5,
                                   atol=1e-5)
    m = np.random.default_rng(2).standard_normal((s, s)).astype(np.float32)
    _close(scaled_dot_product_attention(tq, tk, tv, attn_mask=torch.tensor(
        m), is_causal=True), jattn.scaled_dot_product_attention(
            jq, jk, jv, attn_mask=jnp.asarray(m), is_causal=True), "float32")


def test_sdpa_float_mask_with_grad_takes_the_plain_core():
    """A float mask that wants a gradient (a learned bias) takes the
    differentiable plain core at any length, as a traced float mask takes
    JAX's XLA path: the values equal the plain core's, and the mask's
    gradient equals ``jax.grad`` of ``_xla_attention``."""
    b, s, h, d = 1, FLASH_MIN_SEQ, 2, 64
    (jq, tq), (jk, tk), (jv, tv), (jc, tc) = _inputs(
        9, [(b, s, h, d)] * 4, "float32")
    m0 = np.random.default_rng(3).standard_normal((b, h, s, s)) \
        .astype(np.float32)
    m = torch.tensor(m0, requires_grad=True)
    out = scaled_dot_product_attention(tq, tk, tv, attn_mask=m)
    torch.testing.assert_close(out, _plain_attention(tq, tk, tv,
                                                     attn_mask=m),
                               rtol=0, atol=0)
    (out * tc).sum().backward()
    jgrad = jax.grad(lambda mm: jnp.sum(jattn._xla_attention(
        jq, jk, jv, mm) * jc))(jnp.asarray(m0))
    _close(m.grad, jgrad, "float32")


def test_sdpa_dropout_in_training_raises():
    """Dropout in training draws its mask now (the plain core below
    FLASH_MIN_SEQ, the flash dropout mode from it on); a probability
    outside [0, 1) raises on the flash route, where 1 / (1 - p) would
    be infinite; eval mode takes no dropout."""
    q = torch.zeros((1, 16, 2, 64))
    out = scaled_dot_product_attention(q, q, q, dropout_p=0.1)
    assert out.shape == q.shape
    out = scaled_dot_product_attention(q, q, q, dropout_p=0.1,
                                       training=False)
    assert out.shape == q.shape
    q = torch.zeros((1, FLASH_MIN_SEQ, 2, 64))
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        scaled_dot_product_attention(q, q, q, dropout_p=1.0)
    assert torch.equal(scaled_dot_product_attention(
        q, q, q, dropout_p=1.0, training=False),
        scaled_dot_product_attention(q, q, q))


def test_unported_modes_and_cpu_tensors_raise():
    """Segment ids with a bias or with dropout raise (the kernels have no
    such mode: no path of the JAX package combines them); the wrappers
    launch on CUDA tensors or raise, in every mode (bias, dropout, both,
    segment ids)."""
    q = torch.zeros((1, 256, 2, 64))
    lse = torch.zeros((1, 2, 256))
    bias = torch.zeros((1, 1, 256, 256))
    seed = torch.tensor([1, 2])
    seg = (np.zeros(256), np.zeros(256))
    with pytest.raises(ValueError, match="segment ids with a bias or with "
                                         "dropout"):
        T.flash_block_grads(q, q, q, q, lse, lse, scale=0.125,
                            causal=True, seg=seg, bias=bias)
    with pytest.raises(ValueError, match="segment ids with a bias or with "
                                         "dropout"):
        T.flash_block_grads(q, q, q, q, lse, lse, scale=0.125,
                            causal=True, seg=seg, dropout_p=0.1,
                            seed_arr=seed)
    with pytest.raises(ValueError, match="broadcast"):
        T.flash_attention(q, q, q, attn_mask=torch.zeros(3, 256, 256))
    with pytest.raises(ValueError, match="seed_arr"):
        T.flash_block_grads(q, q, q, q, lse, lse, scale=0.125,
                            causal=False, bias=bias, dropout_p=0.1)
    # the wrappers launch on CUDA tensors or raise: never a CPU fallback
    for b_, p_, s_ in ((None, 0.0, None), (bias, 0.0, None),
                       (None, 0.1, seed), (bias, 0.1, seed)):
        with pytest.raises(ValueError, match="CUDA"):
            flash_fwd_cuda(q, q, q, 0.125, True, b_, p_, s_)
        with pytest.raises(ValueError, match="CUDA"):
            flash_bwd_dq_cuda(q, q, q, q, lse, lse, 0.125, True, b_, p_, s_)
        with pytest.raises(ValueError, match="CUDA"):
            flash_bwd_dkv_cuda(q, q, q, q, lse, lse, 0.125, False, b_, p_,
                               s_)
    with pytest.raises(ValueError, match="CUDA"):
        flash_fwd_cuda(q, q, q, 0.125, True, seg=seg)
    with pytest.raises(ValueError, match="CUDA"):
        flash_bwd_dq_cuda(q, q, q, q, lse, lse, 0.125, True, seg=seg)
    with pytest.raises(ValueError, match="CUDA"):
        flash_bwd_dkv_cuda(q, q, q, q, lse, lse, 0.125, True, seg=seg)


@pytest.mark.parametrize("sq,sk,causal,bias_kind", [
    (256, 256, True, None), (320, 256, True, None),
    (256, 320, False, "float_2d"), (256, 256, True, "float_4d")])
def test_flash_fp32_d128_matches_pallas(sq, sk, causal, bias_kind):
    """fp32 at head dim 128: the plain forward and backward against the
    JAX kernels (interpret mode) at 2e-5, as ``test_flash_plain_versions_
    match_pallas``; ``sq > sk`` leaves rows that see no key."""
    b, h, d = 1, 2, 128
    scale = d ** -0.5
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = _inputs(
        sq + sk + (bias_kind is None), [(b, sq, h, d), (b, sk, h, d),
                                        (b, sk, h, d), (b, sq, h, d)],
        "float32")
    jm = tbias = None
    if bias_kind is not None:
        m = (np.random.default_rng(sq).standard_normal(
            (sq, sk) if bias_kind == "float_2d" else (b, h, sq, sk)) * 2) \
            .astype(np.float32)
        jm, tbias = jnp.asarray(m), T.pad_bias(torch.tensor(m), b, h, sq,
                                               sk)
    to, tl = T.flash_fwd_plain(tq, tk, tv, scale, causal, tbias)
    delta = flash_delta(tdo, to)

    def run(q, k, v, do, delta, m):
        o, lse = J._fwd(q, k, v, scale, causal, bias=m)
        return (o, lse) + tuple(J.flash_block_grads(
            q, k, v, do, lse, delta, scale=scale, causal=causal, bias=m))

    jo, jl, *jg = jax.jit(run)(jq, jk, jv, jdo, jnp.asarray(delta.numpy()),
                               jm)
    _close(to, jo, "float32")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-5,
                               atol=2e-5)
    tg = T.flash_block_grads_plain(tq, tk, tv, tdo,
                                   torch.tensor(np.asarray(jl)), delta,
                                   scale, causal, tbias)
    for got, want in zip(tg, jg):
        _close(got, want, "float32")


def _dropout_reference(q, k, v, scale, causal, bias, p, seed):
    """``softmax(q k^T * scale + bias) * keep / (1 - p) @ v`` in fp64, the
    keep mask of ``keep_mask`` under ``seed``; differentiable. A row that
    sees no key (its bias all -1e30) gives 0, the kernels' convention
    (the subtracted max clamped at -1e25)."""
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        s = s.masked_fill(~torch.ones(sq, sk, dtype=torch.bool).tril(
            sk - sq), -np.inf)
    if bias is not None:
        s = s + bias.double()
    keep = keep_mask(seed, p, b * h, sq, sk).view(b, h, sq, sk)
    e = torch.exp(s - s.amax(-1, keepdim=True).clamp(min=-1e25))
    l = e.sum(-1, keepdim=True)
    probs = e / torch.where(l == 0, 1.0, l)
    probs = torch.where(keep, probs / (1 - p), 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


DROPOUT_CASES = [(256, True, None), (320, False, None),
                 (256, False, "float_4d"), (320, True, "bool_keypad")]


@pytest.mark.parametrize("s,causal,bias_kind", DROPOUT_CASES)
def test_flash_dropout_matches_fp64_composition(s, causal, bias_kind):
    """The forward (plain version) and autograd through
    ``flash_attention(dropout_p=0.1, fixed_seed_offset=...)`` against the
    fp64 composition with the same mask: fp32 tolerance 2e-5 (the plain
    versions keep the Pallas arithmetic in fp32, the reference is the
    same function in fp64). ``flash_block_grads(dropout_p, seed_arr)``
    gives the autograd gradients from the forward's statistics."""
    b, h, d, p = 2, 2, 64, 0.1
    scale = d ** -0.5
    pair = (2 ** 31 + 12345, 678)
    seed = torch.tensor(pair)
    (_, tq), (_, tk), (_, tv), (_, tc) = _inputs(
        s + 3 * causal, [(b, s, h, d)] * 4, "float32")
    mask = None
    if bias_kind is not None:
        _, tm = _masks(bias_kind, b, h, s, s, 17)
        mask = tm
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    out = T.flash_attention(*leaves, causal=causal, attn_mask=mask,
                            dropout_p=p, fixed_seed_offset=pair)
    (out * tc).sum().backward()
    ref_leaves = [t.double().requires_grad_(True) for t in (tq, tk, tv)]
    bias = None if mask is None else T.attn_bias(mask, tq, tk)
    ref = _dropout_reference(*ref_leaves, scale, causal, bias, p, seed)
    (ref * tc.double()).sum().backward()
    _close(out.detach(), ref.detach().float(), "float32")
    for leaf, want in zip(leaves, ref_leaves):
        _close(leaf.grad, want.grad.float(), "float32")
    # the building blocks: forward plain version, backward from its stats
    o, lse = T.flash_fwd_plain(tq, tk, tv, scale, causal, bias, p, seed)
    assert torch.equal(o, out.detach())
    grads = T.flash_block_grads(tq, tk, tv, tc, lse, flash_delta(tc, o),
                                scale=scale, causal=causal, bias=bias,
                                dropout_p=p, seed_arr=pair)
    for got, leaf in zip(grads, leaves):
        torch.testing.assert_close(got, leaf.grad, rtol=0, atol=0)


def test_flash_dropout_keys_and_p0():
    """``p = 0`` is the no-dropout mode, bitwise; one key gives one output
    twice, another key another; a key drawn from a generator follows the
    generator's state."""
    b, s, h, d = 1, 256, 2, 64
    (_, tq), (_, tk), (_, tv) = _inputs(5, [(b, s, h, d)] * 3, "float32")
    none = T.flash_attention(tq, tk, tv, causal=True)
    assert torch.equal(T.flash_attention(tq, tk, tv, causal=True,
                                         dropout_p=0.0,
                                         fixed_seed_offset=(1, 2)), none)
    a = T.flash_attention(tq, tk, tv, causal=True, dropout_p=0.1,
                          fixed_seed_offset=(1, 2))
    assert torch.equal(a, T.flash_attention(tq, tk, tv, causal=True,
                                            dropout_p=0.1,
                                            fixed_seed_offset=(1, 2)))
    assert not torch.equal(a, T.flash_attention(
        tq, tk, tv, causal=True, dropout_p=0.1, fixed_seed_offset=(1, 3)))
    assert not torch.equal(a, none)
    g = torch.Generator().manual_seed(9)
    state = g.get_state()
    x = T.flash_attention(tq, tk, tv, dropout_p=0.1, generator=g)
    y = T.flash_attention(tq, tk, tv, dropout_p=0.1, generator=g)
    g.set_state(state)
    assert torch.equal(x, T.flash_attention(tq, tk, tv, dropout_p=0.1,
                                            generator=g))
    assert not torch.equal(x, y)
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        T.flash_attention(tq, tk, tv, dropout_p=-0.1)
