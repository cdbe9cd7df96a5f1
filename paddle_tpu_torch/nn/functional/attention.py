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
- :func:`scaled_dot_product_attention` — uncached attention: from
  ``FLASH_MIN_SEQ`` query rows on it takes flash attention
  (``ops/kernels/flash_attention.py``; the CUDA kernels on the card, their
  plain versions on the CPU), below that the plain core, as the JAX
  package routes it on its accelerator.

bf16 note: a bf16 product in PyTorch returns bf16, while the JAX code
asks XLA for the fp32 sum (``preferred_element_type``). The plain cores
therefore upcast bf16 operands to fp32 before each product; bf16
products are exact in fp32, so only the order of the sums differs.
"""

from __future__ import annotations

import math

import torch

from ...ops.kernels.flash_attention import flash_attention
from ...ops.kernels.paged_attention import (paged_attention_cuda,
                                            paged_attention_plain)
from ...ops.kernels.routing import use_kernel
from ...quantization.serving import QuantizedKV, kv_dequantize

__all__ = ["scaled_dot_product_attention", "cached_prefill_attention",
           "paged_attention_decode", "FLASH_MIN_SEQ"]

# the JAX package's FLAGS_flash_min_seq default (core/flags.py): from
# this query length on, it runs the Pallas flash kernel on its device
FLASH_MIN_SEQ = 256


def _plain_attention(q, k, v, is_causal=False):
    """Counterpart of ``_xla_attention`` (attention.py:37) without mask
    or dropout: fp32 scores and softmax, probabilities cast to the input
    dtype for the PV product, fp32 accumulation, one cast back."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if is_causal:
        causal = torch.ones((sq, sk), dtype=torch.bool,
                            device=q.device).tril(diagonal=sk - sq)
        scores = scores.masked_fill(~causal, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def scaled_dot_product_attention(query, key, value, is_causal=False):
    """Uncached attention (counterpart: attention.py:325), q/k/v with the
    same head count, differentiable. A query of FLASH_MIN_SEQ rows or
    more takes :func:`flash_attention` on every device; a shorter one the
    plain core (the counterpart of ``_xla_attention``)."""
    if query.shape[1] >= FLASH_MIN_SEQ:
        return flash_attention(query, key, value, causal=is_causal)
    return _plain_attention(query, key, value, is_causal=is_causal)


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
