"""Kernel 2: paged decode attention (CUDA, ``csrc/paged_attention.cu``).

Replaces ``paddle_tpu/ops/pallas/paged_attention.py::paged_attention_tpu``
in both its modes: fp pools, and int8 pools (codes ``[P, ps, kvh, d]``
with fp32 row scales ``k_scale``/``v_scale`` ``[P, ps, kvh]``,
dequantized inside the page loop). See the source for what bounds it on
the H100, how the design answers that, and which arithmetic it
reproduces (the grouped GQA core's, not the TPU kernel's).

- :func:`paged_attention_plain` — the plain PyTorch version: gather the
  block-table pages (and scales), then the grouped core (CPU path,
  tests, and the yardstick on the card);
- :func:`paged_attention_cuda` — the kernel's wrapper: launches on CUDA
  tensors or raises on anything outside :func:`kernel_gate`;
  ``paged_attention_cuda.launches`` counts its fp-mode launches and
  ``paged_attention_cuda.int8_launches`` its int8-mode ones.

The router is ``nn.functional.paged_attention_decode``: its ``t == 1``
rows take the kernel on CUDA, its ``t > 1`` rows take the gather path
on every device, as the JAX package routes them.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .build import library

__all__ = ["paged_attention_plain", "paged_attention_cuda", "kernel_gate",
           "HEAD_DIMS", "MAX_GROUP"]

HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 16
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def paged_attention_plain(q, pool_k, pool_v, block_tables, seq_lens,
                          scale: float | None = None, k_scale=None,
                          v_scale=None) -> torch.Tensor:
    """Gather ``[b, max_pages * page_size, kvh, d]`` by block table, then
    the grouped GQA core (attention.py:505-520 of the JAX package). With
    ``k_scale``/``v_scale`` the pools hold int8 codes: codes and scales
    are gathered by the same table and the core dequantizes them."""
    from ...nn.functional.attention import _grouped_decode_attn
    from ...quantization.serving import QuantizedKV
    b, _, h, d = q.shape
    kvh = pool_k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    idx = block_tables.long()
    kg = pool_k[idx].reshape(b, -1, kvh, d)
    vg = pool_v[idx].reshape(b, -1, kvh, d)
    if k_scale is not None:
        kg = QuantizedKV(kg, k_scale[idx].reshape(b, -1, kvh))
        vg = QuantizedKV(vg, v_scale[idx].reshape(b, -1, kvh))
    return _grouped_decode_attn(q, kg, vg, seq_lens, scale)


def _int8_gate(pool_k, k_scale, v_scale) -> str | None:
    if (k_scale is None) != (v_scale is None):
        return "k_scale and v_scale come together"
    if k_scale is None:
        if pool_k.dtype == torch.int8:
            return "int8 pools need k_scale and v_scale"
        return None
    if pool_k.dtype != torch.int8:
        return "k_scale/v_scale go with int8 pools"
    for s in (k_scale, v_scale):
        if s.dtype != torch.float32 or tuple(s.shape) != tuple(
                pool_k.shape[:3]):
            return ("scales must be float32 [num_pages, page_size, kvh] "
                    "beside int8 pools")
    return None


def kernel_gate(q, pool_k, pool_v, block_tables, seq_lens, k_scale=None,
                v_scale=None) -> str | None:
    """None when the kernel takes these inputs, else the reason it
    does not."""
    tensors = (q, pool_k, pool_v, block_tables, seq_lens) + tuple(
        s for s in (k_scale, v_scale) if s is not None)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        return "all inputs must be on one CUDA device"
    if q.dim() != 4 or q.shape[1] != 1:
        return f"q must be [b, 1, h, d]; got {tuple(q.shape)}"
    b, _, h, d = q.shape
    if pool_k.dim() != 4 or pool_v.shape != pool_k.shape:
        return "pools must be two equal [num_pages, page_size, kvh, d]"
    kvh = pool_k.shape[2]
    if pool_k.shape[3] != d or d not in HEAD_DIMS:
        return f"head dim must be one of {HEAD_DIMS} in q and pools"
    if h % kvh or not 1 <= h // kvh <= MAX_GROUP:
        return (f"h={h} must be a multiple of kvh={kvh} with at most "
                f"{MAX_GROUP} query heads per kv head")
    if (q.dtype not in (torch.float32, torch.bfloat16)
            or pool_k.dtype not in _DTYPE_CODE
            or pool_v.dtype != pool_k.dtype):
        return ("q must be float32 or bfloat16, and the pools float32, "
                "bfloat16 or int8")
    why = _int8_gate(pool_k, k_scale, v_scale)
    if why is not None:
        return why
    if (block_tables.dtype != torch.int32 or block_tables.dim() != 2
            or block_tables.shape[0] != b or seq_lens.dtype != torch.int32
            or tuple(seq_lens.shape) != (b,)):
        return "block_tables must be int32 [b, M] and seq_lens int32 [b]"
    if not all(t.is_contiguous() for t in tensors):
        return "inputs must be contiguous"
    if pool_k.data_ptr() % 16 or pool_v.data_ptr() % 16:
        return "pools must start 16-byte aligned"
    if b > 65535:
        return "at most 65535 slots"
    return None


def _fn():
    fn = library("paged_attention").paged_decode_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def paged_attention_cuda(q, pool_k, pool_v, block_tables, seq_lens,
                         scale: float | None = None, k_scale=None,
                         v_scale=None) -> torch.Tensor:
    """q ``[b, 1, h, d]``; pools ``[num_pages, page_size, kvh, d]``;
    block_tables int32 ``[b, M]``; seq_lens int32 ``[b]`` (inclusive:
    slot s attends positions ``0..seq_lens[s]``). Int8 mode: int8 pools
    with fp32 ``k_scale``/``v_scale`` ``[num_pages, page_size, kvh]``.
    Returns ``[b, 1, h, d]`` in q's dtype. Raises ValueError outside
    :func:`kernel_gate`. ``seq_lens`` must be >= 0; a value past
    ``M * page_size - 1`` attends all ``M * page_size`` positions, as the
    gather path does."""
    why = kernel_gate(q, pool_k, pool_v, block_tables, seq_lens, k_scale,
                      v_scale)
    if why is not None:
        raise ValueError(f"paged_attention_cuda: {why}")
    b, _, h, d = q.shape
    _, ps, kvh, _ = pool_k.shape
    M = block_tables.shape[1]
    g = h // kvh
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    if b == 0:
        return out
    scores = torch.empty((b, kvh, g, M * ps), dtype=torch.float32,
                         device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _fn()(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
                    k_scale.data_ptr() if k_scale is not None else None,
                    v_scale.data_ptr() if v_scale is not None else None,
                    block_tables.data_ptr(), seq_lens.data_ptr(),
                    out.data_ptr(), scores.data_ptr(), b, kvh, g, d, ps, M,
                    float(scale), _DTYPE_CODE[q.dtype],
                    _DTYPE_CODE[pool_k.dtype], stream)
    if err != 0:
        raise RuntimeError(f"paged attention kernel launch failed: CUDA "
                           f"error {err}")
    if k_scale is None:
        paged_attention_cuda.launches += 1
    else:
        paged_attention_cuda.int8_launches += 1
    return out


paged_attention_cuda.launches = 0
paged_attention_cuda.int8_launches = 0
