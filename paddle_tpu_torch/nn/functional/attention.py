"""Attention functionals (counterpart: paddle_tpu/nn/functional/attention.py).

Layout ``[batch, seq, heads, head_dim]``, as in the JAX package. Three
entry points carry the serving path:

- :func:`paged_attention_decode` — the engine's attention over the
  paged KV pool. ``t == 1`` rows (the decode step) take the CUDA kernel
  on the card; ``t > 1`` rows (the mixed step's prefill chunks) take the
  gather + grouped core on every device, as the JAX package routes them
  (its ``kernel_applicable`` gates on ``t == 1``).
- :func:`cached_prefill_attention` — the contiguous-cache twin sharing
  the same grouped core.
- :func:`scaled_dot_product_attention` — uncached attention, with an
  optional mask: from ``FLASH_MIN_SEQ`` query rows on it takes flash
  attention (``ops/kernels/flash_attention.py``; the CUDA kernels on the
  card, their plain versions on the CPU; a mask rides in the kernels'
  bias mode, dropout in their dropout mode), below that the plain core,
  as the JAX package routes it on its accelerator.

bf16 note: a bf16 product in PyTorch returns bf16, while the JAX code
asks XLA for the fp32 sum (``preferred_element_type``). The plain cores
therefore upcast bf16 operands to fp32 before each product; bf16
products are exact in fp32, so only the order of the sums differs.
"""

from __future__ import annotations

import math

import torch

from ...ops.kernels.flash_attention import NEG, flash_attention
from ...ops.kernels.paged_attention import (paged_attention_cuda,
                                            paged_attention_plain)
from ...ops.kernels.routing import use_kernel
from ...quantization.serving import QuantizedKV, kv_dequantize

__all__ = ["scaled_dot_product_attention", "cached_prefill_attention",
           "paged_attention_decode", "FLASH_MIN_SEQ"]

# the JAX package's FLAGS_flash_min_seq default (core/flags.py): from
# this query length on, it runs the Pallas flash kernel on its device
FLASH_MIN_SEQ = 256


def _rank4(m):
    """The paddle rank convention of the masks (attention.py:54-60):
    ``[sq, sk]`` -> ``[1, 1, sq, sk]``, ``[b, sq, sk]`` -> ``[b, 1, sq,
    sk]`` (per batch, not per head)."""
    if m.dim() == 2:
        return m[None, None]
    if m.dim() == 3:
        return m[:, None]
    return m


def _plain_attention(q, k, v, is_causal=False, attn_mask=None,
                     dropout_p=0.0, generator=None):
    """Counterpart of ``_xla_attention`` (attention.py:37-81): fp32 scores
    and softmax, probabilities cast to the input dtype for the PV
    product, fp32 accumulation, one cast back. A bool mask keeps where
    True and puts -1e30 elsewhere (a fully masked row comes out uniform,
    not NaN); a float mask is added, and its gradient flows. With
    ``dropout_p`` the probabilities take ``where(keep, p / (1 - p_drop),
    0)``, the keep mask ``torch.rand(.., generator) < 1 - p_drop`` (the
    counterpart of ``bernoulli(1 - p_drop)``, :77-80)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if is_causal:
        causal = torch.ones((sq, sk), dtype=torch.bool,
                            device=q.device).tril(diagonal=sk - sq)
        scores = scores.masked_fill(~causal, float("-inf"))
    if attn_mask is not None:
        m = _rank4(attn_mask)
        if m.dtype == torch.bool:
            scores = scores.masked_fill(~m, NEG)
        else:
            scores = scores + m.float()
    probs = torch.softmax(scores, dim=-1)
    if dropout_p:
        keep = torch.rand(probs.shape, generator=generator,
                          device=q.device) < 1.0 - dropout_p
        probs = torch.where(keep, probs / (1.0 - dropout_p),
                            torch.zeros((), device=q.device))
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def _normalize_kernel_mask(mask, b, h, sq, sk):
    """Counterpart of ``_normalize_kernel_mask`` (attention.py:306): the
    mask broadcast to ``[b|1, h|1, sq, sk]`` (a stride-0 view, nothing
    copied), or None when it does not broadcast so (then the caller
    takes the plain core, as the JAX package takes its XLA path)."""
    m = _rank4(mask)
    if m.dim() != 4 or m.shape[0] not in (1, b) or m.shape[1] not in (1, h):
        return None
    try:
        return m.expand(m.shape[0], m.shape[1], sq, sk)
    except RuntimeError:
        return None


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, generator=None):
    """Uncached attention (counterpart: attention.py:325), q/k/v with the
    same head count, differentiable in q, k and v. A query of
    FLASH_MIN_SEQ rows or more takes :func:`flash_attention` on every
    device, its mask normalised as ``_normalize_kernel_mask`` does, with
    dropout in training in the kernels' dropout mode (its key drawn from
    ``generator``); a shorter one, a float mask that wants a gradient
    (the JAX package sends such a mask, a tracer, to its differentiable
    XLA path, :210) or a mask that does not broadcast to the kernels'
    shape take the plain core (the counterpart of ``_xla_attention``),
    with the same rank convention and its keep mask drawn from
    ``generator``. The draws are ``torch.Generator``'s, not
    ``jax.random``'s (ROADMAP.md A1)."""
    p = dropout_p if training else 0.0
    q, k = query, key
    if q.shape[1] >= FLASH_MIN_SEQ:
        if attn_mask is None:
            return flash_attention(q, k, value, causal=is_causal,
                                   dropout_p=p, generator=generator)
        if attn_mask.dtype == torch.bool or not attn_mask.requires_grad:
            m = _normalize_kernel_mask(attn_mask, q.shape[0], q.shape[2],
                                       q.shape[1], k.shape[1])
            if m is not None:
                return flash_attention(q, k, value, causal=is_causal,
                                       attn_mask=m, dropout_p=p,
                                       generator=generator)
    return _plain_attention(q, k, value, is_causal=is_causal,
                            attn_mask=attn_mask, dropout_p=p,
                            generator=generator)


def _grouped_decode_attn(q, kc, vc, seq_lens, scale):
    """The grouped GQA core (counterpart: attention.py:380). q
    ``[b, t, h, d]`` grouped as ``[kvh, g]`` against the unrepeated cache
    ``[b, S, kvh, d]``; row j attends positions ``<= seq_lens + j``.
    q is cast to the cache dtype, scores accumulate in fp32, masked
    scores take -1e30 (a padded tail contributes exactly 0), and the
    probabilities are cast to the cache dtype for the PV product. A
    ``QuantizedKV`` cache is dequantized to fp32 first, so q and the
    probabilities stay fp32 (attention.py:399-402)."""
    if isinstance(kc, QuantizedKV):
        kc, vc = kv_dequantize(kc), kv_dequantize(vc)
    b, t, h, d = q.shape
    S, kvh = kc.shape[1], kc.shape[2]
    g = h // kvh
    qg = q.reshape(b, t, kvh, g, d).to(kc.dtype)
    s = torch.einsum("btngd,bsnd->btngs", qg.float(), kc.float()) * scale
    rows = torch.arange(t, device=q.device)
    limit = seq_lens.long()[:, None] + rows[None, :]                # [b, t]
    mask = (torch.arange(S, device=q.device)[None, None, None, None, :]
            <= limit[:, :, None, None, None])
    s = torch.where(mask, s, torch.tensor(-1e30, dtype=torch.float32,
                                          device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("btngs,bsnd->btngd", p.to(vc.dtype).float(),
                       vc.float())
    return out.reshape(b, t, h, d).to(q.dtype)


def cached_prefill_attention(q, kc, vc, seq_lens, scale=None):
    """Causal attention of new rows against a contiguous cache that
    already holds them (counterpart: attention.py:428)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _grouped_decode_attn(q, kc, vc, seq_lens, scale)


def paged_attention_decode(q, pool_k, pool_v, block_tables, seq_lens,
                           scale=None):
    """Attention over the paged KV pool (counterpart: attention.py:458).

    q ``[b, t, h, d]``; pools ``[num_pages, page_size, kvh, d]``, or two
    ``QuantizedKV`` (int8 codes and fp32 ``[num_pages, page_size, kvh]``
    scales); block_tables int32 ``[b, max_pages]``; seq_lens int32
    ``[b]`` — row j attends pool positions ``<= seq_lens + j``. A CUDA
    ``t == 1`` call launches kernel 2, in its int8 mode for a quantized
    pool (raising on a shape it does not take); every other call gathers
    the pages (codes and scales by the same table) and runs the grouped
    core (attention.py:497-516)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    scales = {}
    if isinstance(pool_k, QuantizedKV):
        scales = {"k_scale": pool_k.scale, "v_scale": pool_v.scale}
        pool_k, pool_v = pool_k.q, pool_v.q
    if q.shape[1] == 1 and use_kernel(q):
        return paged_attention_cuda(q, pool_k, pool_v, block_tables,
                                    seq_lens, scale, **scales)
    return paged_attention_plain(q, pool_k, pool_v, block_tables, seq_lens,
                                 scale, **scales)
