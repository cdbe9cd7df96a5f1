#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--layers N]

Phases; any failure ends the run with a traceback and a non-zero exit:

1. device — the card's name and power limit (``nvidia-smi``);
2. build — every kernel from ``paddle_tpu_torch/csrc``, one ``nvcc`` per
   source, all started together;
3. kernel vs plain — each kernel against its plain PyTorch version in
   bf16 at its path's shapes (RMSNorm and paged decode, fp and int8
   modes, at the serving shapes, each launched twice and bitwise equal;
   the paged kernel also at a long context, ``LONG_CONTEXTS``, with
   SDPA as its yardstick, and over its gate, ``paged_sweep``: q fp32 and
   bf16 against fp32, bf16 and int8 pools, d 32 and 64, G 1, 8 and 16,
   pages of 1, 5 and 64 positions, live lengths on and one past the
   kernel's 64-position chunk edges, each case repeated bitwise; flash forward, dQ and dK/dV at the
   Llama training shape, plus ragged shapes, sq != sk, BERT-Base's shape
   without a bias, scores far below 0 and q, k, v as views of one fused
   tensor (``FLASH_CASES``), each launched twice and bitwise equal;
   LayerNorm at the BERT
   training shape and a ragged one; the bias mode of the three flash
   kernels at the padded BERT shape with its key-padding mask, plus a
   dense [b, h, sq, sk] bias and a causal [sq, sk] one at a ragged
   length (the backward launched twice and bitwise equal), and their
   no-bias mode at the unpadded BERT shape; MoE
   routing and the grouped-GEMM forward, dX and dW at the Qwen2-MoE
   training shapes, after ``MOE_EDGES`` (a padded capacity not a
   multiple of the 128-slot block with the ungated relu FFN, and slot
   blocks with no token); ``moe_fp32_kernels``: their fp32 mode (3xTF32) at
   the fp32 slice's shapes (H 512), both FFN kinds at a smaller one and
   one expert holding all 8192 tokens (``MOE_FP32_LONG``: dW's long
   chain), against fp64 within 2x the plain fp32 version's error plus a
   floor, each launched twice for a bitwise repeat;
   the int8 paged mode and the MoE kernels launched twice for a bitwise
   repeat; ``flash_fp32``: the fp32 mode of the three flash kernels
   (3xTF32 products) against fp64 at GPT-2 small's, ``entry()``'s and
   BERT-Base's shapes, with and without a bias, causal and not, d 64 and
   128, each output within 2x the plain fp32 version's error plus a
   stated floor, and at rows that see one key (a 1-token segment and a
   key-padding mask leaving one key, d 128; at d 64, where the forward
   and backward run the TF32 wgmma kernels, sk 1 and causal sq > sk:
   ROADMAP C6);
   ``flash_dropout``: the dropout mode (p 0.1), bf16 and
   fp32, with and without a bias, d 64 and 128, on one Philox key with
   its plain version, two launches bitwise equal; ``flash_varlen``: the segment
   mode (packed sequences) on ``bench_llama``'s first packed host step,
   8 documents, 8,760 tokens, bf16 [8760, 16, 128] causal and not, fp32
   [8760, 12, 64] causal against fp64, and a cross-attention batch with
   a keyless segment; its yardsticks SDPA with the dense block-diagonal
   mask and one SDPA a document), with its time (CUDA events over many launches, inputs
   rotated through more than the 50 MB L2), the plain version's time,
   the least time the card could take (the bound) and, as a yardstick
   only, PyTorch calls computing the same products;
3b. varlen_packed — the packed-sequence path through its entry points:
   the port's native ``pack_sequences`` (its C++ library built) packs
   that host step, its ``cu`` become ``cu_seqlens``, and
   ``nn.functional.flash_attn_unpadded`` (bf16 causal, fp32 causal) and
   ``incubate.nn.functional.variable_length_memory_efficient_attention``
   (bf16 non-causal) run forward and backward: exactly the segment
   mode's launches; each document held against that document alone
   through the no-segment kernels;
4. train — the JAX package's one-chip Llama training configuration
   (``bench.py::_llama_flagship``: 8 layers at full width, bf16, AdamW at
   lr 1e-4, batch 4 x seq 2048) with seeded random weights made on the
   card: 10 ``TrainStep``s on a fixed batch, step time, tokens/s, MFU,
   peak memory, every loss, and the launch counters read around this
   phase alone;
5. train parity — three steps from one state through the kernels and
   again inside ``plain_reference()``: per-step |loss difference|, the
   first step's gradients, and the parameters after step 3;
6. train profile — one training step under ``torch.profiler``; its
   flash forward must be the wgmma kernel alone (``check_wgmma_forward``,
   also in ``train_moe_profile`` with the grouped forward's wgmma passes,
   and in both BERT arms' profiles);
7. train_moe, train_moe_parity, train_moe_profile — phases 4-6 for the
   JAX package's ``qwen2_moe_fused`` configuration (8 sparse layers of 16
   experts, top-2, full width, bf16, batch 8 x seq 1024), with
   ``mfu_active``, the aux losses and the dropped copies per layer;
7b. train_moe_fp32, train_moe_fp32_parity, train_moe_fp32_profile — the
   same configuration in fp32 with its expert width cut from 704 to 512
   (``moe_fp32_config``: the width the fused gates admit in fp32; the cut
   is printed), through the fp32 modes of the flash and grouped-GEMM
   kernels only; parity at ``FP32_PARITY`` with each MoE layer's own
   output and input gradient, and routing decisions that may differ only
   below ``ROUTE_MARGIN``; the profiled step's flash forward and
   backward must be the plain TF32 wgmma kernels alone, and its grouped
   forward, dX and dW the TF32 wgmma ones of the gated FFN
   (``check_fp32_grouped_forward``, ``check_fp32_grouped_backward``);
8. train_bert, train_bert_padded, train_bert_parity, train_bert_profile
   — ``bench.py::bench_bert``'s configuration (BERT-Base at full width
   and depth, bf16, AdamW lr 1e-4, batch 32 x seq 512): 10 steps of
   exactly its step (input ids only; the LayerNorm kernel and the
   no-bias flash kernels), then from the same weights 10 steps on a
   padded batch (seeded lengths 128-512, token types, an attention mask,
   MLM labels -100 on padding: the bias mode of the flash kernels), each
   with the report of phase 4 and its own launch counts; train parity
   (with an fp32 copy's gradients telling which gradients bf16 cannot
   resolve) and one profiled step on the padded arm (each arm's flash
   backward: the wgmma kernels in its mode alone);
8b. entry_fp32 — ``__graft_entry__.py::entry()``'s fp32 Llama (4
   layers, hidden 512, 8 / 4 heads of 64, [2, 256] ids from
   ``default_rng(0)``): its eval forward on the card (4 fp32 flash
   launches) against ``plain_reference()``, then 3 fp32 training steps
   of train parity and one profiled step (the plain TF32 wgmma forward
   and backward alone);
8c. train_gpt2, train_gpt2_parity, train_gpt2_profile — GPT-2 small at
   its published defaults (``paddle_tpu/models/gpt.py``: fp32, dropout
   0.1, 12 layers of 12 heads of 64, 124,475,904 parameters), b 8 x s
   1024, AdamW lr 1e-4: phase 4's report for 10 steps (the fp32 dropout
   flash kernels 12 a step, LayerNorm 25), 3 steps of parity at dropout
   0.1 from one generator state, one profiled step (its flash forward
   and backward: the TF32 wgmma dropout kernels alone);
8d. train_bert_defaults — BERT-Base at its own defaults (fp32, dropout
   0.1) on the padded batch: 3 steps (the fp32 bias + dropout mode, 12 a
   step) and one profiled step (its flash forward and backward: the
   TF32 wgmma bias + dropout kernels alone), an eval forward and 2 steps
   at dropout 0 (the fp32 bias mode) with one profiled step (the TF32
   wgmma bias kernels alone);
   train_dropout_bf16 — 10 steps each of GPT-2 small and BERT-Base in
   bf16 at dropout 0.1 (the bf16 dropout modes), one profiled step of
   each (its flash forward and backward: the wgmma kernels in the arm's
   mode, no bf16 mma.sync kernel), and ``train_dropout_bf16_parity``: 3 steps
   through the kernels and 3 inside ``plain_reference()`` from one
   generator state, at ``DROP_BF16_PARITY``;
9. slice parity — one decode step on one serving engine state, kernels
   vs plain versions (logits within ``SLICE_DLOGIT_LIMIT``, decisive
   rows equal, the kernels' launch counts);
10. serve — Llama-3-8B widths in bf16 with seeded random weights made on
   the card, 8 requests x 32 greedy tokens through ``ServingEngine``
   (including a prefix hit and a copy-on-write), the launch counters
   read around this phase alone;
11. profile — one mixed and three decode steps under ``torch.profiler``:
    host wall, device time, idle share and the top kernels per step;
12. serve_int8 — the same model after ``quantize_for_serving(inplace=
    True)`` (int8 weights) replays the serve trace over the int8 KV pool
    (``kv_quant=True``), after a slice-parity decode step of its own
    (``slice_parity_int8``): the int8 mode of the paged kernel must take
    every decode step and the fp mode none; then ``profile_int8`` (phase
    11 over the int8 model, with the ``Int8ServingLinear`` share of each
    step's device time) and, for information only, how many leading
    tokens of each int8 stream equal the bf16 stream of its request;
13. a ``{"kernels": [...]}`` line for every ported kernel and mode.

The card's name and power limit are printed again on the line before
the last; the last line is ``{"ok": true, "device": {...}}``. Without a
CUDA device, or without the repository around this file, it exits
non-zero before printing any result. ``--layers`` cuts the serving
model's depth (never width) and the cut is printed; the training phases
always run their full configurations. Each model is freed before the
next is built.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_TENSOR_FLOPS = 989e12     # dense bf16 tensor-core peak
FP32_FLOPS = 67e12             # fp32 outside the tensor cores
# The fastest fp32-accurate product rate: 3xTF32 (hi*hi + hi*lo + lo*hi,
# three passes) on the 494.7 TFLOP/s dense TF32 tensor-core peak; plain
# fp32 FMA peaks at FP32_FLOPS. The fp32 flash kernels' bound uses it.
FP32_ACCURATE_FLOPS = 494.7e12 / 3
SEED = 0


def _nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()


def _emit(tag: str, payload) -> None:
    print(json.dumps({tag: payload}), flush=True)


def _time_ms(torch, fn, arg_sets, iters=100, warmup=10) -> float:
    """Mean ms per call over ``iters`` launches cycling ``arg_sets``."""
    for i in range(warmup):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(torch, fn, arg_sets, iters=50):
    """Mean device time per call: the summed durations of the GPU
    activities in a ``torch.profiler`` trace of ``iters`` calls. None
    when the profiler records no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for i in range(5):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    return us / 1e3 / iters if us > 0 else None


def _timings(torch, fns, arg_sets, own_sets=None) -> dict:
    """CUDA-event time per call (what a caller waits, host included) and
    profiler device time per call, for each of kernel/plain/library.
    ``own_sets`` gives a version its own argument sets."""
    out = {}
    for key, fn in fns.items():
        prefix = "" if key == "kernel" else key + "_"
        sets = (own_sets or {}).get(key, arg_sets)
        out[prefix + "ms"] = _time_ms(torch, fn, sets)
        out[prefix + "device_ms"] = _device_ms(torch, fn, sets)
    return out


def _counts(K, **nonzero) -> dict:
    """Every kernel's launch count: 0 but for ``nonzero``."""
    out = dict.fromkeys(K.launch_counts(), 0)
    out.update(nonzero)
    return out


def _host_probe_us(torch, K) -> float:
    """Host cost of one launch: mean us per call over 200 back-to-back
    RMSNorm launches on [8, 4096] rows (~2.5 us of device time each, so
    the host sets the pace). Read at the start and again before the
    serve phase, whose step time is host-bound: the two readings show
    whether the host got slower in between (every earlier phase uses
    ``torch.profiler``)."""
    x = torch.ones((8, 4096), device="cuda", dtype=torch.bfloat16)
    w = torch.ones((4096,), device="cuda", dtype=torch.bfloat16)
    return 1e3 * _time_ms(torch, lambda: K.rms_norm_cuda(x, w, 1e-6), [()],
                          iters=200)


def phase_rms_norm(torch, K) -> list[dict]:
    """RMSNorm at the decode step's [8, 4096] and the mixed step's
    [512, 4096] rows, and the training step's [8192, 2048]; at [8, 4096]
    also the router ``rms_norm`` under ``no_grad`` (the serving path) and
    with a weight that wants a gradient (the autograd.Function). bf16
    tolerance: one bf16 ulp (rtol 2**-7) — kernel and plain round the
    same fp32 value, whose last bits depend on the order of the sums."""
    eps = 1e-6
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for n, d in ((8, 4096), (512, 4096), (8192, 2048)):
        sets = [(torch.randn((n, d), generator=gen, device="cuda")
                 .mul_(3).bfloat16(),
                 torch.randn((d,), generator=gen, device="cuda").bfloat16())
                for _ in range(16 if n * d < 2 ** 22 else 4)]
        x, w = sets[0]
        got = K.rms_norm_cuda(x, w, eps)
        torch.cuda.synchronize()
        want = K.rms_norm_plain(x, w, eps)
        torch.testing.assert_close(got.float(), want.float(), atol=1e-6,
                                   rtol=2 ** -7)
        err = (got.float() - want.float()).abs().max().item()
        nbytes = (2 * n * d + d) * 2
        flops = 4 * n * d
        bound = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3
        rows.append({
            "shape": [n, d], "max_abs_err": err,
            "tolerance": "rtol 2**-7 (one bf16 ulp)",
            **_timings(torch, {
                "kernel": lambda a, b: K.rms_norm_cuda(a, b, eps),
                "plain": lambda a, b: K.rms_norm_plain(a, b, eps),
                "library": lambda a, b: torch.nn.functional.rms_norm(
                    a, (d,), b, eps)}, sets),
            "bound_ms": bound,
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= flops / FP32_FLOPS else "operations")})
        if n == 8:   # the router's host cost at the decode step's rows
            with torch.no_grad():   # serving: the wrapper, called directly
                rows[-1]["router_no_grad_ms"] = _time_ms(
                    torch, lambda a, b: K.rms_norm(a, b, eps), sets)
            graph_sets = [(a, b.detach().requires_grad_(True))
                          for a, b in sets]   # training: autograd.Function
            rows[-1]["router_autograd_ms"] = _time_ms(
                torch, lambda a, b: K.rms_norm(a, b, eps), graph_sets)
        _emit("kernel_vs_plain", {"name": "rms_norm", **rows[-1]})
    return rows


def _sdpa_over(torch, q, kg, vg, seq_lens):
    """PyTorch's scaled_dot_product_attention over gathered
    ``[b, S, kvh, d]`` K and V, positions past ``seq_lens`` masked."""
    S = kg.shape[1]
    mask = (torch.arange(S, device=q.device)[None, :]
            <= seq_lens.long()[:, None])[:, None, None, :]
    out = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), kg.transpose(1, 2), vg.transpose(1, 2),
        attn_mask=mask, enable_gqa=True)
    return out.transpose(1, 2)


def _sdpa_yardstick(torch, q, pk, pv, tables, seq_lens):
    """Gather + PyTorch's scaled_dot_product_attention over the same
    pages: the yardstick only (the port never calls it)."""
    b, _, h, d = q.shape
    kvh = pk.shape[2]
    kg = pk[tables.long()].reshape(b, -1, kvh, d)
    vg = pv[tables.long()].reshape(b, -1, kvh, d)
    return _sdpa_over(torch, q, kg, vg, seq_lens)


def _sdpa_int8_yardstick(torch, q, kq, vq, tables, seq_lens, ks, vs):
    """Gather codes and scales, dequantize to q's dtype, then PyTorch's
    scaled_dot_product_attention: the int8 mode's yardstick only."""
    b, _, h, d = q.shape
    kvh = kq.shape[2]
    idx = tables.long()
    kg = (kq[idx].float() * ks[idx][..., None]).to(q.dtype)
    vg = (vq[idx].float() * vs[idx][..., None]).to(q.dtype)
    return _sdpa_over(torch, q, kg.reshape(b, -1, kvh, d),
                      vg.reshape(b, -1, kvh, d), seq_lens)


# seq_lens of phase_paged's slots: k*16-1 and k*16 values, one inactive
# slot (None) and a ~300-token context
PAGED_LENS = (15, 16, 127, None, 300, 64, 255, 200)


def paged_inputs(torch, gen, lens=PAGED_LENS, h=32, kvh=8, d=128, ps=16,
                 M=32, n_sets=16) -> list:
    """Argument sets of the paged kernel's bf16 mode: b = len(lens) slots
    (seq_lens ``lens``, None an inactive slot: seq_lens 0 and a table of
    scratch page 0), each slot on its own random pages of a pool of
    b * M + 1 pages. The defaults are phase_paged's serving shapes: 16
    sets of ~4 MB of live KV cycle through the 50 MB L2."""
    b = len(lens)
    n_pages = b * M + 1
    sets = []
    for _ in range(n_sets):
        perm = torch.randperm(n_pages - 1, generator=gen,
                              device="cuda") + 1
        tables = torch.zeros((b, M), dtype=torch.int32, device="cuda")
        seq = torch.zeros((b,), dtype=torch.int32, device="cuda")
        for s, n in enumerate(lens):
            if n is not None:
                live = -(-(n + 1) // ps)
                tables[s, :live] = perm[s * M:s * M + live].int()
                seq[s] = n
        shape = (n_pages, ps, kvh, d)
        sets.append((
            torch.randn((b, 1, h, d), generator=gen,
                        device="cuda").bfloat16(),
            torch.randn(shape, generator=gen, device="cuda").bfloat16(),
            torch.randn(shape, generator=gen, device="cuda").bfloat16(),
            tables, seq))
    return sets


def paged_errors(torch, K, args, atol=1e-2) -> dict:
    """The paged kernel (fp mode) against its plain version on one
    argument set, within ``atol``; two launches must agree bitwise.
    Returns the errors and a list of failures."""
    got = K.paged_attention_cuda(*args)
    again = K.paged_attention_cuda(*args)
    torch.cuda.synchronize()
    want = K.paged_attention_plain(*args)
    out = {"max_abs_err": (got.float() - want.float()).abs().max().item(),
           "bitwise_repeat": bool(torch.equal(got, again))}
    out["failures"] = (
        ([] if out["max_abs_err"] <= atol else
         [f"max |err| {out['max_abs_err']:.3g} > {atol}"])
        + ([] if out["bitwise_repeat"] else ["two launches differ"]))
    return out


def _paged_bound(b, h, kvh, d, positions, elem_bytes, scale_bytes=0,
                 M=32, flops_per_s=BF16_TENSOR_FLOPS, dequant=False):
    """The paged kernel's least time (ms) and what bounds it: q in and
    out (bf16), each live K and V row (and its scale) read once, the
    tables and seq_lens; 4 operations per KV element pair (+ 2 per
    element to dequantize)."""
    nbytes = (2 * b * h * d * 2
              + 2 * positions * kvh * (d * elem_bytes + scale_bytes)
              + b * M * 4 + b * 4)
    flops = 4 * positions * h * d + (2 * positions * kvh * d if dequant
                                     else 0)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops
            else "operations", nbytes)


def phase_paged(torch, K) -> dict:
    """Paged decode at the serving shapes: b=8 slots, h=32, kvh=8,
    d=128, page 16, 32-page tables; ragged lengths with k*16-1 and k*16
    values, one inactive slot and a ~300-token context (``PAGED_LENS``).
    bf16 tolerance 1e-2 absolute: two bf16 ulps at |out| < 2 — q, the
    probabilities and the output are each rounded to bf16, and a
    rounding can flip by one ulp when the fp32 sums before it run in
    another order. Two launches must agree bitwise."""
    b, h, kvh, d, ps, M = len(PAGED_LENS), 32, 8, 128, 16, 32
    sets = paged_inputs(torch, torch.Generator(device="cuda").manual_seed(
        SEED + 1))
    errs = paged_errors(torch, K, sets[0])
    if errs["failures"]:
        raise AssertionError(f"paged kernel differs from its plain "
                             f"version: {errs}")
    want = K.paged_attention_plain(*sets[0])
    lib_err = (_sdpa_yardstick(torch, *sets[0]).float()
               - want.float()).abs().max().item()
    positions = sum((n if n is not None else 0) + 1 for n in PAGED_LENS)
    bound, bound_by, _ = _paged_bound(b, h, kvh, d, positions, 2, M=M)
    row = {
        "shape": {"b": b, "h": h, "kvh": kvh, "d": d, "page_size": ps,
                  "max_pages": M, "seq_lens": [n if n is not None else 0
                                               for n in PAGED_LENS],
                  "inactive_slots": [3]},
        **{k: v for k, v in errs.items() if k != "failures"},
        "tolerance": "atol 1e-2 (two bf16 ulps)",
        "library_max_abs_err": lib_err,
        **_timings(torch, {
            "kernel": K.paged_attention_cuda,
            "plain": K.paged_attention_plain,
            "library": lambda *a: _sdpa_yardstick(torch, *a)}, sets),
        "bound_ms": bound, "bound_by": bound_by}
    _emit("kernel_vs_plain", {"name": "paged_attention", **row})
    return row

# decode contexts of the serve trace half way through its 32 tokens: the
# seven first prompts (default_rng(0), 64..255 tokens) and the follow-up
# turn (275 tokens), each + 16
SERVE_CONTEXTS = (243, 202, 178, 131, 139, 87, 94, 291)


# outputs below this magnitude are held to one bf16 ulp of it: near zero
# an output is a cancelling sum, and the fp32 rounding of its terms
# (7e-7 between fp32 and fp64 at the serve shapes, measured on the CPU)
# is many ulps of the output itself; one ulp here is 2**-16, ~10x that
INT8_ULP_FLOOR = 2.0 ** -8


def _bf16_half_ulps(torch, got, want, floor=INT8_ULP_FLOOR) -> float:
    """The largest |got - want| in units of half a bf16 ulp of
    max(|want|, floor) (bf16 keeps 8 significant bits: for |v| in
    [2**k, 2**(k+1)) an ulp is 2**(k-7))."""
    ref = want.float().abs().clamp(min=floor)
    _, e = torch.frexp(ref)
    half = torch.ldexp(torch.ones_like(ref), e - 9)
    return ((got.float() - want.float()).abs() / half).max().item()


def paged_int8_inputs(torch, QZ, gen, n_sets=24, contexts=SERVE_CONTEXTS,
                      M=32) -> list:
    """Argument sets of the int8 paged kernel at the serving shapes: b=8
    slots, h=32, kvh=8, d=128, page 16, 32-page tables, bf16 q, int8
    pools made by ``kv_quantize`` from normal values, the serve trace's
    decode contexts (``SERVE_CONTEXTS``), each slot on its own random
    pages. 24 sets of ~2.9 MB of live codes and scales cycle through
    more than the 50 MB L2. ``contexts`` and ``M`` give other seq_lens
    and table widths (one slot per context)."""
    b, h, kvh, d, ps = len(contexts), 32, 8, 128, 16
    n_pages = b * M + 1
    sets = []
    for _ in range(n_sets):
        perm = torch.randperm(n_pages - 1, generator=gen,
                              device="cuda") + 1
        tables = torch.zeros((b, M), dtype=torch.int32, device="cuda")
        for s, n in enumerate(contexts):
            live = -(-(n + 1) // ps)
            tables[s, :live] = perm[s * M:s * M + live].int()
        seq = torch.tensor(contexts, dtype=torch.int32, device="cuda")
        shape = (n_pages, ps, kvh, d)
        ck = QZ.kv_quantize(torch.randn(shape, generator=gen, device="cuda"))
        cv = QZ.kv_quantize(torch.randn(shape, generator=gen, device="cuda"))
        sets.append((torch.randn((b, 1, h, d), generator=gen,
                                 device="cuda").bfloat16(),
                     ck.q, cv.q, tables, seq, ck.scale, cv.scale))
    return sets


def _paged_int8(K, q, kq, vq, tables, seq, ks, vs):
    return K.paged_attention_cuda(q, kq, vq, tables, seq, k_scale=ks,
                                  v_scale=vs)


def _paged_int8_plain(K, q, kq, vq, tables, seq, ks, vs):
    return K.paged_attention_plain(q, kq, vq, tables, seq, k_scale=ks,
                                   v_scale=vs)


def paged_int8_errors(torch, K, args) -> dict:
    """The int8 kernel against its plain version on one argument set.
    Tolerance: one bf16 ulp (2 half-ulps) of the plain output, or of
    ``INT8_ULP_FLOOR`` below it: both dequantize each element in fp32
    and keep q and the probabilities in fp32, so their fp32 outputs
    differ only by the order of the sums, and each is rounded to bf16
    once. Two launches on the same inputs must agree bitwise. Returns
    the errors and a list of failures."""
    got = _paged_int8(K, *args)
    again = _paged_int8(K, *args)
    torch.cuda.synchronize()
    want = _paged_int8_plain(K, *args)
    out = {"max_abs_err": (got.float() - want.float()).abs().max().item(),
           "max_err_half_ulps": _bf16_half_ulps(torch, got, want),
           "bitwise_repeat": bool(torch.equal(got, again))}
    out["failures"] = (
        ([] if out["max_err_half_ulps"] <= 2.0 else
         [f"{out['max_err_half_ulps']:.3g} half-ulps > 2"])
        + ([] if out["bitwise_repeat"] else ["two launches differ"]))
    return out


def phase_paged_int8(torch, K, QZ) -> dict:
    """The paged kernel's int8 mode against its plain version at the
    serving shapes (``paged_int8_inputs``, ``paged_int8_errors``), with
    its times, its byte bound and, as a yardstick only, gather +
    dequantize to bf16 + PyTorch's SDPA."""
    sets = paged_int8_inputs(
        torch, QZ, torch.Generator(device="cuda").manual_seed(SEED + 7))
    errs = paged_int8_errors(torch, K, sets[0])
    if errs["failures"]:
        raise AssertionError(f"int8 paged kernel differs from its plain "
                             f"version: {errs}")
    q, kq = sets[0][:2]
    b, _, h, d = q.shape
    M, kvh = sets[0][3].shape[1], kq.shape[2]
    lib_err = (_sdpa_int8_yardstick(torch, *sets[0]).float()
               - _paged_int8_plain(K, *sets[0]).float()).abs().max().item()
    positions = sum(n + 1 for n in SERVE_CONTEXTS)
    bound, bound_by, nbytes = _paged_bound(
        b, h, kvh, d, positions, 1, 4, M=M, flops_per_s=FP32_FLOPS,
        dequant=True)
    row = {
        "shape": {"b": b, "h": h, "kvh": kvh, "d": d,
                  "page_size": kq.shape[1], "max_pages": M,
                  "seq_lens": list(SERVE_CONTEXTS), "q": "bfloat16",
                  "pools": "int8 + fp32 row scales"},
        **{k: v for k, v in errs.items() if k != "failures"},
        "tolerance": "2 half-ulps (one bf16 ulp) of max(|plain|, 2**-8)",
        "library_max_abs_err": lib_err,
        **_timings(torch, {
            "kernel": lambda *a: _paged_int8(K, *a),
            "plain": lambda *a: _paged_int8_plain(K, *a),
            "library": lambda *a: _sdpa_int8_yardstick(torch, *a)}, sets),
        "bound_ms": bound, "bound_bytes": nbytes, "bound_by": bound_by}
    _emit("kernel_vs_plain", {"name": "paged_attention_int8", **row})
    return row


# the long-context point: 8 slots of 4096 live positions (seq_lens 4095)
# over 256-page tables of 16 positions, every chunk of the kernel live
LONG_CONTEXTS = (4095,) * 8
LONG_PAGES = 256


def phase_paged_long(torch, K, QZ) -> dict:
    """The paged kernel at a long context (``LONG_CONTEXTS``: b 8, h 32,
    kvh 8, d 128, page 16, M 256), bf16 and int8 pools: each against
    its plain version under phase_paged's and phase_paged_int8's rules
    (two launches bitwise equal), with its times, its byte bound (~134
    MB of bf16 K and V) and gather + SDPA as the yardstick. Three
    argument sets, each past the 50 MB L2."""
    b, h, kvh, d = len(LONG_CONTEXTS), 32, 8, 128
    positions = sum(n + 1 for n in LONG_CONTEXTS)
    out = {"shape": {"b": b, "h": h, "kvh": kvh, "d": d, "page_size": 16,
                     "max_pages": LONG_PAGES,
                     "seq_lens": list(LONG_CONTEXTS)}}
    sets = paged_inputs(torch, torch.Generator(device="cuda").manual_seed(
        SEED + 21), LONG_CONTEXTS, M=LONG_PAGES, n_sets=3)
    errs = paged_errors(torch, K, sets[0])
    bound, bound_by, nbytes = _paged_bound(b, h, kvh, d, positions, 2,
                                           M=LONG_PAGES)
    out["bf16"] = {
        **{k: v for k, v in errs.items() if k != "failures"},
        **_timings(torch, {
            "kernel": K.paged_attention_cuda,
            "library": lambda *a: _sdpa_yardstick(torch, *a)}, sets),
        "bound_ms": bound, "bound_by": bound_by, "bound_bytes": nbytes}
    failures = [f"bf16: {f}" for f in errs["failures"]]
    del sets
    torch.cuda.empty_cache()
    sets = paged_int8_inputs(
        torch, QZ, torch.Generator(device="cuda").manual_seed(SEED + 22),
        n_sets=3, contexts=LONG_CONTEXTS, M=LONG_PAGES)
    errs = paged_int8_errors(torch, K, sets[0])
    bound, bound_by, nbytes = _paged_bound(
        b, h, kvh, d, positions, 1, 4, M=LONG_PAGES, flops_per_s=FP32_FLOPS,
        dequant=True)
    out["int8"] = {
        **{k: v for k, v in errs.items() if k != "failures"},
        **_timings(torch, {
            "kernel": lambda *a: _paged_int8(K, *a),
            "library": lambda *a: _sdpa_int8_yardstick(torch, *a)}, sets),
        "bound_ms": bound, "bound_by": bound_by, "bound_bytes": nbytes}
    failures += [f"int8: {f}" for f in errs["failures"]]
    del sets
    torch.cuda.empty_cache()
    out["bf16_over_bound"] = out["bf16"]["device_ms"] / out["bf16"][
        "bound_ms"] if out["bf16"]["device_ms"] else None
    _emit("paged_long", out)
    if failures:
        raise AssertionError(f"paged kernel at the long context: {failures}")
    return out


# the gate sweep: seq_lens giving live lengths 64 and 128 (multiples of
# the kernel's 64-position chunk), 65 and 129 (a multiple plus one), 11
# (inside one chunk) and an inactive slot
SWEEP_LENS = (63, 64, 127, 128, 10, None)


def paged_sweep_cases() -> list:
    """(q dtype, pool dtype, d, G, page size) of the gate sweep: q fp32
    and bf16 against fp32, bf16 and int8 pools, d 32 and 64, G 1, 8 and
    16, pages of 1, 5 and 64 positions; and G 16 over fp32 pools at d
    128 (the largest shared-memory footprint), page 16."""
    import itertools
    cases = list(itertools.product(("float32", "bfloat16"),
                                   ("float32", "bfloat16", "int8"),
                                   (32, 64), (1, 8, 16), (1, 5, 64)))
    return cases + [(qd, "float32", 128, 16, 16)
                    for qd in ("float32", "bfloat16")]


def paged_case_inputs(torch, QZ, gen, qd, pool, d, g, ps, kvh=2,
                      lens=SWEEP_LENS, device="cuda") -> tuple:
    """One argument set of a sweep case, (q, pool_k, pool_v, tables,
    seq_lens, k_scale, v_scale), scales None outside int8."""
    b = len(lens)
    M = -(-max(n + 1 for n in lens if n is not None) // ps) + 1
    n_pages = b * M + 1
    perm = torch.randperm(n_pages - 1, generator=gen, device=device) + 1
    tables = torch.zeros((b, M), dtype=torch.int32, device=device)
    seq = torch.zeros((b,), dtype=torch.int32, device=device)
    for s, n in enumerate(lens):
        if n is not None:
            live = -(-(n + 1) // ps)
            tables[s, :live] = perm[s * M:s * M + live].int()
            seq[s] = n
    shape = (n_pages, ps, kvh, d)
    k = torch.randn(shape, generator=gen, device=device)
    v = torch.randn(shape, generator=gen, device=device)
    q = torch.randn((b, 1, g * kvh, d), generator=gen,
                    device=device).to(getattr(torch, qd))
    if pool == "int8":
        ck, cv = QZ.kv_quantize(k), QZ.kv_quantize(v)
        return q, ck.q, cv.q, tables, seq, ck.scale, cv.scale
    dt = getattr(torch, pool)
    return q, k.to(dt), v.to(dt), tables, seq, None, None


def paged_case_errors(torch, K, args, qd, pool) -> dict:
    """A sweep case against the plain version, two launches bitwise
    equal. Tolerances, as the CUDA tests state them: an fp32 output over
    fp32 or int8 pools 2e-5 absolute (the same arithmetic, sums in
    another order); a bf16 output over int8 pools one bf16 ulp (2
    half-ulps) of max(|plain|, 2**-8); every other case 1e-2 absolute
    (two bf16 ulps at |out| < 2)."""
    q, pk, pv, tables, seq, ks, vs = args

    def run(fn):
        return fn(q, pk, pv, tables, seq, k_scale=ks, v_scale=vs)
    got, again = run(K.paged_attention_cuda), run(K.paged_attention_cuda)
    torch.cuda.synchronize()
    want = run(K.paged_attention_plain)
    out = {"max_abs_err": (got.float() - want.float()).abs().max().item(),
           "bitwise_repeat": bool(torch.equal(got, again)),
           "finite": bool(torch.isfinite(got).all())}
    if pool == "int8" and qd == "bfloat16":
        out["max_err_half_ulps"] = _bf16_half_ulps(torch, got, want)
        ok = out["max_err_half_ulps"] <= 2.0
    else:
        atol = 2e-5 if qd == "float32" and pool != "bfloat16" else 1e-2
        ok = out["max_abs_err"] <= atol
    out["failures"] = (([] if ok else ["outside the tolerance"])
                       + ([] if out["bitwise_repeat"]
                          else ["two launches differ"])
                       + ([] if out["finite"] else ["non-finite output"]))
    return out


def paged_dominant_last(torch, QZ, gen, pool, device="cuda") -> tuple:
    """A case whose largest score sits alone in the context's last
    chunk: one slot of 129 live positions (seq_lens 128: chunks of 64,
    64 and 1), kvh 2, G 4, d 64, pages of 16, bf16 q. Position 128's K
    row of each kv head points along its first query head's q, so that
    head's score there is ~120 (exp(120) overflows fp32: a softmax max
    that misses the last chunk gives inf or NaN). Pools ``pool``
    (bfloat16 or int8)."""
    q, pk, pv, tables, seq, _, _ = paged_case_inputs(
        torch, QZ, gen, "bfloat16", "float32", 64, 4, 16, lens=(128,),
        device=device)
    page, row = int(tables[0, 128 // 16]), 128 % 16
    for n in range(pk.shape[2]):
        q0 = q[0, 0, 4 * n].float()
        pk[page, row, n] = q0 * (120.0 * 64 ** 0.5 / (q0 * q0).sum())
    if pool == "int8":
        ck, cv = QZ.kv_quantize(pk), QZ.kv_quantize(pv)
        return q, ck.q, cv.q, tables, seq, ck.scale, cv.scale
    return q, pk.bfloat16(), pv.bfloat16(), tables, seq, None, None


def paged_sweep_errors(torch, K, QZ, gen, cases=None,
                       device="cuda") -> dict:
    """Each case of ``cases`` (default: every case of
    ``paged_sweep_cases``) and ``paged_dominant_last`` over bf16 and
    int8 pools: the largest error by mode and the failing cases."""
    out = {"cases": 0, "max_abs_err": {}, "max_err_half_ulps": 0.0,
           "failures": []}
    runs = [(c, paged_case_inputs(torch, QZ, gen, *c, device=device))
            for c in cases or paged_sweep_cases()]
    runs += [(("bfloat16", pool, 64, 4, "16 dominant last"),
              paged_dominant_last(torch, QZ, gen, pool, device=device))
             for pool in ("bfloat16", "int8")]
    for (qd, pool, d, g, ps), args in runs:
        errs = paged_case_errors(torch, K, args, qd, pool)
        mode = f"q_{qd}/{pool}"
        out["max_abs_err"][mode] = max(out["max_abs_err"].get(mode, 0.0),
                                       errs["max_abs_err"])
        out["max_err_half_ulps"] = max(out["max_err_half_ulps"],
                                       errs.get("max_err_half_ulps", 0.0))
        out["cases"] += 1
        out["failures"] += [f"{mode} d {d} G {g} page {ps}: {f}"
                            for f in errs["failures"]]
    return out


def phase_paged_sweep(torch, K, QZ) -> dict:
    """The kernel's gate on the card (``paged_sweep_cases``): slots
    whose live lengths sit on and one past the 64-position chunk edges
    (``SWEEP_LENS``), kvh 2, each case against the plain version and
    repeated bitwise."""
    out = paged_sweep_errors(torch, K, QZ, torch.Generator(
        device="cuda").manual_seed(SEED + 23))
    _emit("paged_sweep", out)
    if out["failures"]:
        raise AssertionError(f"paged gate sweep: {out['failures'][:10]}")
    return out


def _flash_work(b, sq, sk, h, d, causal, kind, bias_bytes=0, kept=None,
                elt=2, pairs=None):
    """(flops, bytes) one flash call needs: 2 * d flops per product
    (2 in the forward, 3 in dQ, 4 in dK/dV) for each (query row, key)
    pair the mask keeps — this run's causal shape, not the dense one, and
    with a key-padding mask (``kept``: the valid keys of each batch row)
    only its valid keys; in the segment mode ``pairs``, the pairs a head
    that the segment (and per-segment causal) mask keeps, summed over
    the batch — and each input read once and each output written once
    ([b, s, h, d] tensors of ``elt`` bytes an element: 2 bf16, 4 fp32;
    fp32 [b, h, sq] lse and delta, and in the bias mode the bias's
    distinct fp32 values, in the segment mode the ids and their grain
    summaries: ``bias_bytes``). Dropout adds no bytes (its mask is drawn,
    never stored) and its Philox draws are integer work outside these
    products, not counted."""
    off = sk - sq
    if pairs is None:
        pairs = b * (sum(min(sk, max(0, r + off + 1)) for r in range(sq))
                     if causal else sq * sk)
    n_products = {"fwd": 2, "dq": 3, "dkv": 4}[kind]
    flops = 2.0 * d * h * pairs * n_products
    if kept is not None:              # pairs summed over the batch rows
        flops = 2.0 * d * h * sq * sum(kept) * n_products
    qb, kb, stat = elt * b * sq * h * d, elt * b * sk * h * d, 4 * b * h * sq
    nbytes = {"fwd": 2 * qb + 2 * kb + stat,       # q k v in; out, lse
              "dq": 3 * qb + 2 * kb + 2 * stat,    # q k v dO lse delta; dq
              "dkv": 2 * qb + 4 * kb + 2 * stat,   # same in; dk, dv
              }[kind] + bias_bytes
    return flops, nbytes


def _bound(flops, nbytes, peak=BF16_TENSOR_FLOPS):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# Flash kernels against their plain versions, per output (out, dq, dk,
# dv): each row (one (b, s, h) vector of d elements) within
# FLASH_ROW_RTOL of that row's largest magnitude plus FLASH_ROW_ATOL, and
# the whole output within FLASH_FRO in relative Frobenius norm.
FLASH_ROW_RTOL, FLASH_ROW_ATOL, FLASH_FRO = 2 ** -7, 1e-3, 4e-3


def _flash_errors(torch, F, q, k, v, do, scale, causal, bias=None,
                  dropout_p=0.0, seed_arr=None, seg=None,
                  repeat=False) -> dict:
    """Each flash kernel against its plain version on the same inputs
    (the backward kernels from the plain forward's lse and delta); with
    ``bias`` (fp32 ``[b|1, h|1, sq, sk]``) the kernels' bias mode, both
    versions given the same bias; with ``dropout_p`` their dropout mode,
    both given the same key ``seed_arr`` (so the same mask: a kernel that
    drew another mask would miss these tolerances by far); with ``seg``
    (``F.SegIds``) their segment mode, both given the same ids.

    The plain versions run on fp32 copies of the bf16 inputs: the same
    arithmetic (they upcast first), with outputs that are not rounded to
    bf16. The kernels' error is then their one rounding to bf16 (at most
    2**-8 of a row's largest magnitude) plus the rounding of P and dS to
    bf16 as tensor-core operands (the plain versions keep fp32), which
    moves a sum of many terms by far less; a row is held to 2**-7 of its
    own largest magnitude plus 1e-3 (rows past the first few hundred are
    small in causal attention, so a bound from the whole output's
    largest value would hide a wrong row). The relative Frobenius error
    of one bf16 rounding is ~1.7e-3; 4e-3 leaves room for the P and dS
    roundings and catches a systematic 1% error. lse (fp32 in both):
    1e-4 absolute — bf16 QK products are exact in fp32, only the order
    of the sums and exp2 vs exp differ. Rows that see no key must be
    exact: out 0 and lse -1e30. With ``repeat`` the forward, dQ and dK/dV
    kernels run a second time and must give the same bits.

    Returns per output ``{"max_abs", "row", "fro"}`` (``row``: the worst
    row's error over its tolerance), ``lse`` and ``failures``, a list
    of what broke its tolerance."""
    q32, k32, v32, do32 = (x.float() for x in (q, k, v, do))
    mode = (bias, dropout_p, seed_arr, seg)
    want_o, want_l = F.flash_fwd_plain(q32, k32, v32, scale, causal, *mode)
    delta = F.flash_delta(do, want_o.to(q.dtype))
    got_o, got_l = F.flash_fwd_cuda(q, k, v, scale, causal, *mode)
    got_dq = F.flash_bwd_dq_cuda(q, k, v, do, want_l, delta, scale, causal,
                                 *mode)
    got_dk, got_dv = F.flash_bwd_dkv_cuda(q, k, v, do, want_l, delta,
                                          scale, causal, *mode)
    errs, failures = {}, []
    if repeat:
        out2, lse2 = F.flash_fwd_cuda(q, k, v, scale, causal, *mode)
        if not (torch.equal(out2, got_o) and torch.equal(lse2, got_l)):
            failures.append("a repeat of the forward differs")
        again = (F.flash_bwd_dq_cuda(q, k, v, do, want_l, delta, scale,
                                     causal, *mode),
                 *F.flash_bwd_dkv_cuda(q, k, v, do, want_l, delta, scale,
                                       causal, *mode))
        if not all(torch.equal(a, b_) for a, b_ in
                   zip(again, (got_dq, got_dk, got_dv))):
            failures.append("a repeat of dQ or dK/dV differs")
    torch.cuda.synchronize()
    want_g = F.flash_block_grads_plain(q32, k32, v32, do32, want_l, delta,
                                       scale, causal, *mode)
    for name, got, want in zip(("out", "dq", "dk", "dv"),
                               (got_o, got_dq, got_dk, got_dv),
                               (want_o,) + tuple(want_g)):
        diff = got.float() - want
        row_tol = FLASH_ROW_RTOL * want.abs().amax(-1) + FLASH_ROW_ATOL
        errs[name] = {
            "max_abs": diff.abs().max().item(),
            "row": (diff.abs().amax(-1) / row_tol).max().item(),
            "fro": (diff.norm() / want.norm().clamp(min=1e-30)).item()}
        if not errs[name]["row"] <= 1.0:
            failures.append(f"{name}: a row beyond its tolerance "
                            f"({errs[name]['row']:.3g}x)")
        if not errs[name]["fro"] <= FLASH_FRO:
            failures.append(f"{name}: relative Frobenius error "
                            f"{errs[name]['fro']:.3g} > {FLASH_FRO}")
    dead = want_l <= -1e29
    if not bool(((got_l <= -1e29) == dead).all()):
        failures.append("lse: fully masked rows disagree")
    if bool(dead.any()) and not bool(
            (got_o.transpose(1, 2)[dead] == 0).all()):
        failures.append("out: a fully masked row is not 0")
    errs["lse"] = ((got_l - want_l)[~dead].abs().max().item()
                   if bool((~dead).any()) else 0.0)
    if not errs["lse"] <= 1e-4:
        failures.append(f"lse differs by {errs['lse']} > 1e-4")
    errs["failures"] = failures
    return errs


def _flash_check(torch, F, *args, bias=None, repeat=False) -> dict:
    errs = _flash_errors(torch, F, *args, bias=bias, repeat=repeat)
    if errs["failures"]:
        raise AssertionError(f"flash kernels differ from their plain "
                             f"versions: {errs}")
    return errs


# The no-bias bf16 mode beside the training shape: (b, sq, sk, h, d,
# causal, scores). A ragged length (s 1000: a 128-row block and a 64-key
# tile past the end), causal with sq > sk (rows that see no key) and sq <
# sk, BERT-Base's shape as train_bert runs it (non-causal, d 64), and a
# ragged length where every 7th query scores far below 0 on every key
# ("far": that query -32 in every element, the keys N(0, 1) + 1, so its
# scaled scores lie near -256) and has a zero upstream gradient: a key
# past the end, read as zeros, would take P = exp(0 - lse) = inf there
# (and dS = inf * 0 = NaN) but for its mask. The zero gradient keeps
# those rows' P and dS, rounded to bf16, out of the other rows' sums.
# "fused": q, k, v and dO as strided views of one [b, s, 4, h, d] tensor
# (a fused QKV projection), read through their strides by TMA.
FLASH_CASES = ((2, 1000, 1000, 4, 64, False, "random"),
               (2, 1000, 700, 4, 64, True, "random"),
               (2, 700, 1000, 4, 128, True, "random"),
               (32, 512, 512, 12, 64, False, "random"),
               (2, 1000, 1000, 4, 64, False, "far"),
               (2, 1000, 1000, 4, 128, True, "fused"))


def flash_case_errors(torch, F, gen) -> list:
    """``_flash_errors`` (with a bitwise repeat of the backward) on each
    of ``FLASH_CASES``, inputs from ``gen``."""
    out = []
    for b, sq, sk, h, d, causal, scores in FLASH_CASES:
        if scores == "fused":
            q, k, v, do = torch.randn((b, sq, 4, h, d), generator=gen,
                                      device="cuda").bfloat16().unbind(2)
        else:
            q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                           for shape in ((b, sq, h, d), (b, sk, h, d),
                                         (b, sk, h, d), (b, sq, h, d)))
        if scores == "far":
            q[:, ::7] = -32.0
            k += 1.0
            do[:, ::7] = 0.0
        q, k, v, do = (x.bfloat16() for x in (q, k, v, do))
        out.append(_flash_errors(torch, F, q, k, v, do, d ** -0.5, causal,
                                 repeat=True))
        del q, k, v, do
        torch.cuda.empty_cache()
    return out


def phase_flash(torch, F, shape=(4, 2048, 16, 128)) -> dict:
    """Flash forward, dQ and dK/dV at the training path's shape: q/k/v
    [4, 2048, 16, 128] bf16, causal (each of the 8 layers' attention),
    then ``FLASH_CASES`` (s 1000 non-causal at d 64; causal with sq != sk
    both ways, off = -300 leaving rows that see no key, and off = +300;
    BERT-Base's [32, 512, 12, 64] non-causal; s 1000 with every 7th
    query far below 0; q, k, v and dO as views of one fused tensor), each
    kernel launched twice and bitwise equal.
    Times at
    the path's shape: the kernel, its plain version
    (the backward's plain version computes dq, dk and dv together, so
    dQ and dK/dV report the same plain time), and as a yardstick only
    PyTorch's ``scaled_dot_product_attention(is_causal=True)`` forward
    and its backward through autograd (which computes dq, dk and dv
    together)."""
    b, s, h, d = shape
    scale = d ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()

    sets, lib_fwd, lib_bwd = [], [], []
    for _ in range(3):      # 3 x 134 MB of q, k, v, dO: past the L2
        q, k, v, do = (rand(b, s, h, d) for _ in range(4))
        out, lse = F.flash_fwd_plain(q, k, v, scale, True)
        sets.append((q, k, v, do, lse, F.flash_delta(do, out)))
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        lib_fwd.append((qt, kt, vt))
        og = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)
        lib_bwd.append((og, qt, kt, vt, do.transpose(1, 2)))
    errs = [_flash_check(torch, F, *sets[0][:4], scale, True, repeat=True)]
    torch.cuda.empty_cache()
    with torch.no_grad():
        lib_out = torch.nn.functional.scaled_dot_product_attention(
            *lib_fwd[0], is_causal=True).transpose(1, 2)
    lib_err = (lib_out.float() - F.flash_fwd_plain(
        *sets[0][:3], scale, True)[0].float()).abs().max().item()
    errs += flash_case_errors(torch, F, gen)
    _emit("flash_cases", [{"case": list(c), "errors": e}
                          for c, e in zip(FLASH_CASES, errs[1:])])
    failed = [e["failures"] for e in errs[1:] if e["failures"]]
    if failed:
        raise AssertionError(f"flash kernels differ from their plain "
                             f"versions: {failed}")

    def sdpa_fwd(qt, kt, vt):
        with torch.no_grad():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True)

    def sdpa_bwd(og, qt, kt, vt, dot):
        return torch.autograd.grad(og, (qt, kt, vt), dot, retain_graph=True)

    def plain_bwd(q, k, v, do, lse, delta):
        return F.flash_block_grads_plain(q, k, v, do, lse, delta, scale,
                                         True)

    fns = {
        "flash_fwd": {
            "kernel": lambda q, k, v, *_: F.flash_fwd_cuda(q, k, v, scale,
                                                            True),
            "plain": lambda q, k, v, *_: F.flash_fwd_plain(q, k, v, scale,
                                                            True),
            "library": sdpa_fwd},
        "flash_dq": {
            "kernel": lambda *a: F.flash_bwd_dq_cuda(*a, scale, True),
            "plain": plain_bwd, "library": sdpa_bwd},
        "flash_dkv": {
            "kernel": lambda *a: F.flash_bwd_dkv_cuda(*a, scale, True),
            "plain": plain_bwd, "library": sdpa_bwd},
    }
    err_of = {"flash_fwd": ("out",), "flash_dq": ("dq",),
              "flash_dkv": ("dk", "dv")}
    tolerance = ("against the fp32 plain version: each row within "
                 "2**-7 of its largest magnitude + 1e-3, relative "
                 "Frobenius error <= 4e-3; lse 1e-4 absolute")
    rows, plain_bwd_times = {}, None
    for name, kind in (("flash_fwd", "fwd"), ("flash_dq", "dq"),
                       ("flash_dkv", "dkv")):
        flops, nbytes = _flash_work(b, s, s, h, d, True, kind)
        bound, bound_by = _bound(flops, nbytes)
        fn = fns[name]
        if plain_bwd_times is not None:   # timed once for both passes
            fn = {k_: f for k_, f in fn.items() if k_ == "kernel"}
        lib_sets = lib_fwd if kind == "fwd" else lib_bwd
        t = _timings(torch, fn, sets, {"library": lib_sets})
        if kind != "fwd":
            plain_bwd_times = plain_bwd_times or {
                k_: t[k_] for k_ in ("plain_ms", "plain_device_ms",
                                     "library_ms", "library_device_ms")}
            t.update(plain_bwd_times)
        rows[name] = {
            "shape": {"b": b, "s": s, "h": h, "d": d, "causal": True,
                      "dtype": "bfloat16"},
            "max_abs_err": max(e[o]["max_abs"] for e in errs
                               for o in err_of[name]),
            "max_row_ratio": max(e[o]["row"] for e in errs
                                 for o in err_of[name]),
            "max_rel_fro": max(e[o]["fro"] for e in errs
                               for o in err_of[name]),
            "errors_at_shape": {o: errs[0][o] for o in err_of[name]},
            "max_abs_err_lse": max(e["lse"] for e in errs),
            "tolerance": tolerance, **t, "flops": flops, "bytes": nbytes,
            "bound_ms": bound, "bound_by": bound_by}
        if kind == "fwd":
            rows[name]["library_max_abs_err"] = lib_err
        _emit("kernel_vs_plain", {"name": name, **rows[name]})
    return rows


def layer_norm_errors(torch, K, x, w, b, eps) -> dict:
    """The LayerNorm kernel against its plain version on the same inputs:
    each output within one bf16 ulp of its plain value (``rtol 2**-7``,
    ``atol 1e-6``). Returns the largest error, the worst ratio to the
    tolerance and ``failures``."""
    got = K.layer_norm_cuda(x, w, b, eps)
    torch.cuda.synchronize()
    want = K.layer_norm_plain(x, w, b, eps).float()
    diff = (got.float() - want).abs()
    ratio = (diff / (2 ** -7 * want.abs() + 1e-6)).max().item()
    return {"max_abs": diff.max().item(), "ulp_ratio": ratio,
            "failures": [] if ratio <= 1.0 else
            [f"layer_norm: an output {ratio:.3g}x one bf16 ulp away"]}


def phase_layer_norm(torch, K) -> list[dict]:
    """LayerNorm at the BERT training step's [16384, 768] rows (eps 1e-12,
    the encoder's) and a ragged [16383, 768] (eps 1e-5, ``mlm_norm``'s),
    bf16, with a random weight and bias (the path's start at ones and
    zeros, which would hide a lost scale or shift). bf16 tolerance: one
    bf16 ulp (rtol 2**-7) — kernel and plain round the same fp32 value,
    whose last bits depend on the order of the sums. Yardstick:
    ``torch.nn.functional.layer_norm``."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    rows = []
    for n, d, eps in ((BERT_BATCH * BERT_SEQ, 768, 1e-12),
                      (BERT_BATCH * BERT_SEQ - 1, 768, 1e-5)):
        sets = [(torch.randn((n, d), generator=gen, device="cuda")
                 .mul_(3).add_(1).bfloat16(),
                 torch.randn((d,), generator=gen, device="cuda").bfloat16(),
                 torch.randn((d,), generator=gen, device="cuda").bfloat16())
                for _ in range(4)]
        errs = layer_norm_errors(torch, K, *sets[0], eps)
        if errs["failures"]:
            raise AssertionError(f"the LayerNorm kernel differs from its "
                                 f"plain version: {errs}")
        nbytes = (2 * n * d + 2 * d) * 2
        flops = 8 * n * d
        bound, bound_by = (max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS)
                           * 1e3, "bytes" if nbytes / HBM_BYTES_PER_S
                           >= flops / FP32_FLOPS else "operations")
        rows.append({
            "shape": [n, d], "eps": eps, "max_abs_err": errs["max_abs"],
            "ulp_ratio": errs["ulp_ratio"],
            "tolerance": "rtol 2**-7 (one bf16 ulp)",
            **_timings(torch, {
                "kernel": lambda a, w_, b_: K.layer_norm_cuda(a, w_, b_, eps),
                "plain": lambda a, w_, b_: K.layer_norm_plain(a, w_, b_, eps),
                "library": lambda a, w_, b_: torch.nn.functional.layer_norm(
                    a, (d,), w_, b_, eps)}, sets),
            "bytes": nbytes, "bound_ms": bound, "bound_by": bound_by})
        _emit("kernel_vs_plain", {"name": "layer_norm", **rows[-1]})
    return rows


def bert_lengths(np):
    """The valid lengths of ``train_bert_padded``'s rows: uniform in
    128-512, seeded (a corpus of variable-length documents padded to
    512)."""
    return np.random.default_rng(SEED + 10).integers(128, BERT_SEQ + 1,
                                                     BERT_BATCH)


def phase_flash_bias(torch, np, F) -> dict:
    """The bias mode of flash forward, dQ and dK/dV: at the
    ``train_bert_padded`` shape, q/k/v [32, 512, 12, 64] bf16
    non-causal with that arm's key-padding mask (bool [b, 1, 1, sk] as
    ``attn_bias`` converts it: fp32, a stride-0 view over the queries),
    then a dense random fp32 bias [4, 8, 512, 512] with one query row
    that sees no key (a bias that varies over queries and heads: BERT's
    mask would pass a kernel that applied those strides wrongly), and a
    causal fp32 [sq, sk] bias at s 1000 (not a multiple of the 64-key
    tile) and d 128; each held by the per-output rule of
    ``_flash_errors``. Times at the path's shape: the kernels, their
    plain versions (the backward's plain version computes dq, dk and dv
    together), and as a yardstick PyTorch's
    ``scaled_dot_product_attention`` with the same bool mask, forward and
    backward through autograd; ``no_bias_ms`` is the same kernel's
    no-bias mode on the same q, k, v (the cost of the bias mode). That
    mode is ``train_bert``'s path at this shape, so it is held to its
    plain version on these inputs too (``flash_bert_no_bias``)."""
    b, s, h, d = BERT_BATCH, BERT_SEQ, 12, 64
    scale = d ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()

    lens = torch.tensor(bert_lengths(np), device="cuda")
    keep = (torch.arange(s, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]              # [b, 1, 1, s]
    sets, lib_fwd, lib_bwd = [], [], []
    for _ in range(3):
        q, k, v, do = (rand(b, s, h, d) for _ in range(4))
        bias = F.attn_bias(keep.expand(b, 1, s, s), q, k)
        out, lse = F.flash_fwd_plain(q, k, v, scale, False, bias)
        sets.append((q, k, v, do, lse, F.flash_delta(do, out), bias))
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        lib_fwd.append((qt, kt, vt))
        og = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=keep)
        lib_bwd.append((og, qt, kt, vt, do.transpose(1, 2)))
    bias0 = sets[0][6]
    assert bias0.stride(2) == 0     # converted once, never materialised
    errs = [_flash_check(torch, F, *sets[0][:4], scale, False, bias=bias0,
                         repeat=True)]
    no_bias = _flash_check(torch, F, *sets[0][:4], scale, False)
    _emit("kernel_vs_plain", {
        "name": "flash_bert_no_bias",
        "shape": {"b": b, "s": s, "h": h, "d": d, "causal": False,
                  "dtype": "bfloat16"},
        "errors": no_bias, "max_abs_err": max(
            no_bias[o]["max_abs"] for o in ("out", "dq", "dk", "dv"))})
    torch.cuda.empty_cache()
    dense = torch.randn((4, 8, 512, 512), generator=gen,
                        device="cuda") * 2
    dense[0, 3, 7] = -1e30                     # a row that sees no key
    sq_sk = torch.randn((1000, 1000), generator=gen, device="cuda") * 2
    extra = [((4, 512, 8, 64, False), "dense [b, h, sq, sk]", dense),
             ((2, 1000, 4, 128, True), "[sq, sk]", sq_sk)]
    for (rb, rs, rh, rd, rc), kind, raw in extra:
        errs.append(_flash_check(
            torch, F, rand(rb, rs, rh, rd), rand(rb, rs, rh, rd),
            rand(rb, rs, rh, rd), rand(rb, rs, rh, rd), rd ** -0.5, rc,
            bias=F.pad_bias(raw, rb, rh, rs, rs), repeat=True))
    _emit("flash_bias_extra", [{"shape": list(r), "bias": kind, "errors": e}
                               for (r, kind, _), e in zip(extra, errs[1:])])
    del dense, sq_sk
    torch.cuda.empty_cache()

    def sdpa_fwd(qt, kt, vt):
        with torch.no_grad():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=keep)

    def sdpa_bwd(og, qt, kt, vt, dot):
        return torch.autograd.grad(og, (qt, kt, vt), dot, retain_graph=True)

    def plain_bwd(q, k, v, do, lse, delta, bias):
        return F.flash_block_grads_plain(q, k, v, do, lse, delta, scale,
                                         False, bias)

    fns = {
        "flash_fwd_bias": {
            "kernel": lambda q, k, v, _do, _l, _dl, bias: F.flash_fwd_cuda(
                q, k, v, scale, False, bias),
            "no_bias": lambda q, k, v, *_: F.flash_fwd_cuda(q, k, v, scale,
                                                            False),
            "plain": lambda q, k, v, _do, _l, _dl, bias: F.flash_fwd_plain(
                q, k, v, scale, False, bias),
            "library": sdpa_fwd},
        "flash_dq_bias": {
            "kernel": lambda *a: F.flash_bwd_dq_cuda(*a[:6], scale, False,
                                                     a[6]),
            "no_bias": lambda *a: F.flash_bwd_dq_cuda(*a[:6], scale, False),
            "plain": plain_bwd, "library": sdpa_bwd},
        "flash_dkv_bias": {
            "kernel": lambda *a: F.flash_bwd_dkv_cuda(*a[:6], scale, False,
                                                      a[6]),
            "no_bias": lambda *a: F.flash_bwd_dkv_cuda(*a[:6], scale,
                                                       False),
            "plain": plain_bwd, "library": sdpa_bwd},
    }
    err_of = {"fwd": ("out",), "dq": ("dq",), "dkv": ("dk", "dv")}
    tolerance = ("against the fp32 plain version with the same bias: each "
                 "row within 2**-7 of its largest magnitude + 1e-3, "
                 "relative Frobenius error <= 4e-3; lse 1e-4 absolute; "
                 "fully masked rows exact")
    bias_bytes = 4 * b * s          # the mask's distinct fp32 values
    rows, plain_bwd_times = {}, None
    for name, kind in (("flash_fwd_bias", "fwd"), ("flash_dq_bias", "dq"),
                       ("flash_dkv_bias", "dkv")):
        flops, nbytes = _flash_work(b, s, s, h, d, False, kind, bias_bytes,
                                    kept=[int(x) for x in lens])
        bound, bound_by = _bound(flops, nbytes)
        fn = fns[name]
        if plain_bwd_times is not None:   # timed once for both passes
            fn = {k_: f for k_, f in fn.items()
                  if k_ in ("kernel", "no_bias")}
        t = _timings(torch, fn, sets,
                     {"library": lib_fwd if kind == "fwd" else lib_bwd})
        if kind != "fwd":
            plain_bwd_times = plain_bwd_times or {
                k_: t[k_] for k_ in ("plain_ms", "plain_device_ms",
                                     "library_ms", "library_device_ms")}
            t.update(plain_bwd_times)
        rows[name] = {
            "shape": {"b": b, "s": s, "h": h, "d": d, "causal": False,
                      "dtype": "bfloat16",
                      "bias": "key padding [b, 1, 1, sk] (stride 0 on q)",
                      "valid_keys": int(lens.sum())},
            "max_abs_err": max(e[o]["max_abs"] for e in errs
                               for o in err_of[kind]),
            "max_row_ratio": max(e[o]["row"] for e in errs
                                 for o in err_of[kind]),
            "max_rel_fro": max(e[o]["fro"] for e in errs
                               for o in err_of[kind]),
            "errors_at_shape": {o: errs[0][o] for o in err_of[kind]},
            "max_abs_err_lse": max(e["lse"] for e in errs),
            "tolerance": tolerance, **t, "flops": flops, "bytes": nbytes,
            "bound_ms": bound, "bound_by": bound_by}
        _emit("kernel_vs_plain", {"name": name, **rows[name]})
    return rows


# ---------------- the fp32 and dropout modes of the flash kernels --------

# fp32 flash kernels against an fp64 reference on the card (the plain
# versions run in fp64): each output's error may be at most FP32_RATIO
# times the plain fp32 version's own error plus a floor, in two measures
# (``_rel_errors``): the worst row and the relative Frobenius norm. The
# floor is 3xTF32's own rounding: it keeps 22 of an fp32 operand's 24
# significant bits (two 11-bit TF32 parts), so its products round about 4x
# coarser than fp32 FMA's, and the tensor cores' sums round in their own
# order; 2**-16 of a row (2**-18 in Frobenius norm) is ~60x (~16x) that
# operand rounding. Operands rounded to bf16 (2**-9) miss it ~100x.
FP32_RATIO, FP32_ROW_FLOOR, FP32_FRO_FLOOR = 2.0, 2 ** -16, 2 ** -18
FP32_LSE_FLOOR = 1e-5           # lse (~1-10): a few fp32 ulps of it
DROP_P = 0.1                    # GPT-2's and BERT's attention dropout
GPT2_SHAPE = (8, 1024, 12, 64)  # train_gpt2's attention: b 8, s 1024
ENTRY_SHAPE = (2, 256, 8, 64)   # entry()'s: 8 heads of 64, KV repeated


def _rel_errors(torch, got, ref) -> dict:
    """``got`` against the fp64 ``ref``: the largest error, the worst row
    (its largest error over its largest magnitude plus 2**-6 of the whole
    output's: the dq rows of the first causal queries are differences of
    nearly equal terms, row 0's exactly 0, so their rounding is measured
    against the size of those terms, not of the ~0 result) and the
    relative Frobenius norm."""
    diff = got.double() - ref
    mag = ref.abs()
    scale = mag.amax(-1) + 2 ** -6 * mag.max()
    return {"max_abs": diff.abs().max().item(),
            "row": (diff.abs().amax(-1) / scale.clamp(min=1e-300)).max()
            .item(),
            "fro": (diff.norm() / ref.norm().clamp(min=1e-300)).item()}


def flash_fp32_errors(torch, F, q, k, v, do, scale, causal, bias=None,
                      dropout_p=0.0, seed_arr=None, seg=None) -> dict:
    """The fp32 kernels (forward, dQ, dK/dV; with ``bias``,
    ``dropout_p``/``seed_arr`` and ``seg`` in those modes) and the plain fp32
    versions, each against the plain versions run in fp64 on the same
    inputs (the backward ones from the fp64 forward's lse and delta,
    rounded to fp32). Each output of the kernels is held to
    ``FP32_RATIO`` times the plain fp32 version's error plus
    ``FP32_ROW_FLOOR`` / ``FP32_FRO_FLOOR``; lse to twice the plain
    version's plus ``FP32_LSE_FLOOR``; rows that see no key exactly (out
    0, lse -1e30). Returns per output ``{"kernel": .., "plain": ..}``
    errors (``_rel_errors``), ``lse`` and ``failures``."""
    mode = (bias, dropout_p, seed_arr, seg)
    q64, k64, v64, do64 = (x.double() for x in (q, k, v, do))
    ref_o, ref_l = F.flash_fwd_plain(q64, k64, v64, scale, causal, *mode)
    ref_delta = F.flash_delta(do64, ref_o)
    ref_g = F.flash_block_grads_plain(q64, k64, v64, do64, ref_l, ref_delta,
                                      scale, causal, *mode)
    del q64, k64, v64, do64
    lse, delta = ref_l.float(), ref_delta.float()
    pl_o, pl_l = F.flash_fwd_plain(q, k, v, scale, causal, *mode)
    pl_g = F.flash_block_grads_plain(q, k, v, do, lse, delta, scale, causal,
                                     *mode)
    got_o, got_l = F.flash_fwd_cuda(q, k, v, scale, causal, *mode)
    got_dq = F.flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale, causal,
                                 *mode)
    got_dk, got_dv = F.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, scale,
                                          causal, *mode)
    torch.cuda.synchronize()
    errs, failures = {}, []
    for name, got, plain, ref in zip(
            ("out", "dq", "dk", "dv"), (got_o, got_dq, got_dk, got_dv),
            (pl_o,) + tuple(pl_g), (ref_o,) + tuple(ref_g)):
        ke, pe = _rel_errors(torch, got, ref), _rel_errors(torch, plain, ref)
        errs[name] = {"kernel": ke, "plain": pe}
        for m, floor in (("row", FP32_ROW_FLOOR), ("fro", FP32_FRO_FLOOR)):
            limit = FP32_RATIO * pe[m] + floor
            if not ke[m] <= limit:
                failures.append(f"{name}: {m} error {ke[m]:.3g} > "
                                f"{FP32_RATIO} x plain {pe[m]:.3g} + "
                                f"{floor:.3g}")
    dead = ref_l <= -1e29
    if not bool(((got_l <= -1e29) == dead).all()):
        failures.append("lse: fully masked rows disagree")
    if bool(dead.any()) and not bool(
            (got_o.transpose(1, 2)[dead] == 0).all()):
        failures.append("out: a fully masked row is not 0")
    live = ~dead
    k_lse = (got_l.double() - ref_l)[live].abs().max().item()
    p_lse = (pl_l.double() - ref_l)[live].abs().max().item()
    errs["lse"] = {"kernel": k_lse, "plain": p_lse}
    if not k_lse <= 2 * p_lse + FP32_LSE_FLOOR:
        failures.append(f"lse: {k_lse:.3g} > 2 x plain {p_lse:.3g} + "
                        f"{FP32_LSE_FLOOR}")
    errs["failures"] = failures
    return errs


def _kernel_err(errs):
    """The kernel's errors in a ``flash_fp32_errors`` entry."""
    return errs["kernel"]


def _flash_inputs(torch, gen, shape, dtype):
    return tuple(torch.randn(shape, generator=gen, device="cuda").to(dtype)
                 for _ in range(4))


def _keypad(torch, np, s):
    """``train_bert_padded``'s key-padding mask, bool [b, 1, 1, s]."""
    lens = torch.tensor(bert_lengths(np), device="cuda")
    return (torch.arange(s, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :], lens


def _mode_rows(torch, F, suffix, sets, scale, causal, dropout_p, keep, errs,
               err_of, shape, tolerance, kept=None, elt=4,
               peak=FP32_ACCURATE_FLOPS) -> dict:
    """Times of one mode's three kernels (``flash_{fwd,dq,dkv}`` +
    ``suffix``) on ``sets`` of ``(q, k, v, do, lse, delta, bias, seed)``:
    the kernels, their plain versions (the backward's computes dq, dk and
    dv together, so dQ and dK/dV report the same plain time), and as a
    yardstick PyTorch's ``scaled_dot_product_attention`` with the same
    causal flag, mask (``keep``, bool) and ``dropout_p``, forward and its
    backward through autograd; each beside its bound at ``peak``. The
    errors come from ``errs`` (a list of checks), ``err_of`` picking the
    measure of an output."""
    b, s, h, d = shape

    def mode(a):
        return a[6], dropout_p, a[7]

    lib_fwd, lib_bwd = [], []
    for a in sets:
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in a[:3])
        lib_fwd.append((qt, kt, vt))
        og = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=keep, is_causal=causal,
            dropout_p=dropout_p)
        lib_bwd.append((og, qt, kt, vt, a[3].transpose(1, 2)))

    def sdpa_fwd(qt, kt, vt):
        with torch.no_grad():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=keep, is_causal=causal,
                dropout_p=dropout_p)

    def sdpa_bwd(og, qt, kt, vt, dot):
        return torch.autograd.grad(og, (qt, kt, vt), dot, retain_graph=True)

    fns = {
        "fwd": {"kernel": lambda *a: F.flash_fwd_cuda(*a[:3], scale, causal,
                                                       *mode(a)),
                "plain": lambda *a: F.flash_fwd_plain(*a[:3], scale, causal,
                                                       *mode(a)),
                "library": sdpa_fwd},
        "dq": {"kernel": lambda *a: F.flash_bwd_dq_cuda(*a[:6], scale,
                                                         causal, *mode(a)),
               "plain": lambda *a: F.flash_block_grads_plain(
                   *a[:6], scale, causal, *mode(a)),
               "library": sdpa_bwd},
        "dkv": {"kernel": lambda *a: F.flash_bwd_dkv_cuda(*a[:6], scale,
                                                           causal, *mode(a))},
    }
    outs = {"fwd": ("out",), "dq": ("dq",), "dkv": ("dk", "dv")}
    bias_bytes = 0 if keep is None else 4 * b * s
    rows, bwd_times = {}, None
    for kind in ("fwd", "dq", "dkv"):
        flops, nbytes = _flash_work(b, s, s, h, d, causal, kind, bias_bytes,
                                    kept=kept, elt=elt)
        bound, bound_by = _bound(flops, nbytes, peak)
        t = _timings(torch, fns[kind], sets,
                     {"library": lib_fwd if kind == "fwd" else lib_bwd})
        if kind == "dq":
            bwd_times = {k_: t[k_] for k_ in (
                "plain_ms", "plain_device_ms", "library_ms",
                "library_device_ms")}
        elif kind == "dkv":
            t.update(bwd_times)
        name = f"flash_{kind}{suffix}"
        rows[name] = {
            "shape": shape, "max_abs_err": max(err_of(e[o])["max_abs"]
                                               for e in errs
                                               for o in outs[kind]),
            "errors_at_shape": {o: errs[0][o] for o in outs[kind]},
            "tolerance": tolerance, **t, "flops": flops, "bytes": nbytes,
            "bound_ms": bound, "bound_by": bound_by,
            "bound_peak_flops": peak}
        _emit("kernel_vs_plain", {"name": name, **rows[name]})
    del lib_fwd, lib_bwd
    return rows


def _mode_sets(torch, F, gen, shape, dtype, causal, scale, bias_of=None,
               dropout_p=0.0, seed=None, n=3):
    """``n`` argument sets ``(q, k, v, do, lse, delta, bias, seed)`` of
    one shape and mode for ``_mode_rows`` (lse and delta from the plain
    forward in fp32)."""
    sets = []
    for _ in range(n):
        q, k, v, do = _flash_inputs(torch, gen, shape, dtype)
        bias = None if bias_of is None else bias_of(q, k)
        out, lse = F.flash_fwd_plain(q, k, v, scale, causal, bias, dropout_p,
                                     seed)
        sets.append((q, k, v, do, lse, F.flash_delta(do, out.to(dtype)),
                     bias, seed))
    return sets


FP32_TOLERANCE = ("against the plain versions in fp64 on the card: each "
                  "output's worst-row and relative Frobenius errors at most "
                  f"{FP32_RATIO} x the plain fp32 version's plus "
                  f"2**-16 / 2**-18; lse 2 x plain + {FP32_LSE_FLOOR}; "
                  "fully masked rows exact")
BF16_TOLERANCE = ("against the fp32 plain version on the same inputs (and "
                  "key): each row within 2**-7 of its largest magnitude + "
                  "1e-3, relative Frobenius error <= 4e-3; lse 1e-4 "
                  "absolute")


# tests/test_torch_cuda.py's "touching" segment lengths: a 1-token
# segment, whose row sees one key (ROADMAP C6)
ONE_KEY_LENS = (64, 64, 63, 65, 1, 127, 32)


def one_key_checks(torch, np, F) -> dict:
    """``flash_fp32_errors`` at rows that see one key (ROADMAP C6), fp32:
    their dS = P (dP - delta) is 0 in exact arithmetic, so their dq and
    that key's dk are dP's rounding alone. At d 128, non-causal, the
    segment mode at ``ONE_KEY_LENS`` (a 1-token segment) on the inputs of
    ``test_flash_seg_kernels_match_plain[touching-float32-128-False]``
    (seed 8), where three-pass dP missed the rule, and the bias mode with
    a key-padding mask that leaves batch element 1 one key. At d 64 (the
    TF32 wgmma backward), the plain mode non-causal with one key (sk 1,
    every row) and causal with sq 600 > sk 400 (rows 0-199 see no key,
    row 200 one), and the bias mode with a key-padding mask that leaves
    batch element 1 one key (``one_key_keypad_d64``)."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    ids = np.repeat(np.arange(len(ONE_KEY_LENS)), ONE_KEY_LENS)
    q, k, v, do = _flash_inputs(torch, gen, (2, len(ids), 2, 128),
                                torch.float32)
    out = {"one_key_segment": flash_fp32_errors(
        torch, F, q, k, v, do, 128 ** -0.5, False,
        seg=F.seg_ids(ids, ids, "cuda"))}
    q, k, v, do = _flash_inputs(torch, gen, (2, 200, 2, 128), torch.float32)
    keep1 = (torch.arange(200, device="cuda")[None, :]
             < torch.tensor([200, 1], device="cuda")[:, None])
    out["one_key_keypad"] = flash_fp32_errors(
        torch, F, q, k, v, do, 128 ** -0.5, False,
        F.attn_bias(keep1[:, None, None, :].expand(2, 1, 200, 200), q, k))
    for name, sq, sk, causal in (("one_key_d64_sk1", 256, 1, False),
                                 ("one_key_d64_causal", 600, 400, True)):
        q, do = _flash_inputs(torch, gen, (4, sq, 4, 64), torch.float32)[:2]
        k, v = _flash_inputs(torch, gen, (4, sk, 4, 64), torch.float32)[:2]
        out[name] = flash_fp32_errors(torch, F, q, k, v, do, 0.125, causal)
    q, k, v, do = _flash_inputs(torch, gen, (2, 200, 2, 64), torch.float32)
    out["one_key_keypad_d64"] = flash_fp32_errors(
        torch, F, q, k, v, do, 0.125, False,
        F.attn_bias(keep1[:, None, None, :].expand(2, 1, 200, 200), q, k))
    return out


def dense_bias(torch, F, gen, q, k):
    """A dense random fp32 bias [b, h, sq, sk] for q and k (N(0, 4)), with
    -inf at every 11th key from key 3 and a last query row of -1e30 in
    batch element 0, head 0 (a row that sees no key)."""
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    m = torch.randn((b, h, sq, sk), generator=gen, device="cuda") * 2
    m[..., 3::11] = float("-inf")
    m[0, 0, -1] = -1e30
    return F.pad_bias(m, b, h, sq, sk)


LONG_CHAIN_SHAPE = (1, 8192, 2, 64)


def long_chain_check(torch, F, gen) -> dict:
    """``flash_fp32_errors`` at a long causal fp32 sequence,
    ``LONG_CHAIN_SHAPE``: dQ's sum over keys and dK/dV's over queries run
    256 tiles of 32, where a sum kept on the tensor cores drifts (they
    truncate; PR 6) by more than the rule's floor, as a 1024-row one
    does not (PERF.md §6, PR 14)."""
    q, k, v, do = _flash_inputs(torch, gen, LONG_CHAIN_SHAPE, torch.float32)
    return flash_fp32_errors(torch, F, q, k, v, do, 0.125, True)


def phase_flash_fp32(torch, np, F) -> dict:
    """The fp32 mode of flash forward, dQ and dK/dV (3xTF32 products),
    each held to ``flash_fp32_errors``'s rule: at GPT-2 small's shape
    ([8, 1024, 12, 64] causal), ``train_moe_fp32``'s ([8, 1024, 16, 64]
    causal), ``entry()``'s ([2, 256, 8, 64] causal),
    BERT-Base's ([32, 512, 12, 64] non-causal) without and with
    ``train_bert_padded``'s key-padding mask, at d 128 a causal
    [2, 1024, 8, 128] with a random fp32 [sq, sk] bias and a ragged
    non-causal [2, 1000, 4, 128], at d 64 a non-causal [4, 512, 8, 64]
    with a dense random fp32 [4, 8, 512, 512] bias (``dense_bias``: it
    varies over queries, so a bias read in the wrong frame cannot pass as
    the key-padding one can), the cases of rows that see one key
    (``one_key_checks``: d 128 with segment ids or a bias, d 64 plain and
    with a bias), and a long causal sequence (``long_chain_check``). Times
    (``_mode_rows``, the bound at the 3xTF32 rate) at GPT-2's shape for
    the no-bias mode and at the padded BERT shape for the bias mode; the
    yardstick is
    ``scaled_dot_product_attention`` in fp32."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    keep, lens = _keypad(torch, np, BERT_SEQ)
    b_bert = BERT_BATCH

    def keypad_bias(q, k):
        return F.attn_bias(keep.expand(b_bert, 1, BERT_SEQ, BERT_SEQ), q, k)

    def sq_sk_bias(q, k):
        return F.pad_bias(torch.randn((q.shape[1], k.shape[1]),
                                      generator=gen, device="cuda") * 2,
                          q.shape[0], q.shape[2], q.shape[1], k.shape[1])

    cases = [("gpt2", GPT2_SHAPE, True, None),
             ("qwen2_moe", (MOE_BATCH, MOE_SEQ, 16, 64), True, None),
             ("entry", ENTRY_SHAPE, True, None),
             ("bert", (BERT_BATCH, BERT_SEQ, 12, 64), False, None),
             ("bert_keypad", (BERT_BATCH, BERT_SEQ, 12, 64), False,
              keypad_bias),
             ("d128_causal_bias", (2, 1024, 8, 128), True, sq_sk_bias),
             ("d128_ragged", (2, 1000, 4, 128), False, None),
             ("dense_d64", (4, 512, 8, 64), False,
              lambda q, k: dense_bias(torch, F, gen, q, k))]
    checks = {}
    for name, shape, causal, bias_of in cases:
        q, k, v, do = _flash_inputs(torch, gen, shape, torch.float32)
        bias = None if bias_of is None else bias_of(q, k)
        checks[name] = flash_fp32_errors(torch, F, q, k, v, do,
                                         shape[3] ** -0.5, causal, bias)
        del q, k, v, do, bias
        torch.cuda.empty_cache()
    checks.update(one_key_checks(torch, np, F))
    checks["long_chain"] = long_chain_check(torch, F, gen)
    torch.cuda.empty_cache()
    _emit("flash_fp32_checks", checks)
    failures = {n: c["failures"] for n, c in checks.items() if c["failures"]}
    if failures:
        raise AssertionError(f"fp32 flash kernels beyond tolerance: "
                             f"{failures}")
    rows = _mode_rows(
        torch, F, "_fp32", _mode_sets(torch, F, gen, GPT2_SHAPE,
                                      torch.float32, True, 0.125),
        0.125, True, 0.0, None, [checks["gpt2"], checks["entry"],
                                 checks["d128_ragged"]],
        _kernel_err, GPT2_SHAPE, FP32_TOLERANCE)
    torch.cuda.empty_cache()
    shape = (BERT_BATCH, BERT_SEQ, 12, 64)
    rows.update(_mode_rows(
        torch, F, "_fp32_bias", _mode_sets(torch, F, gen, shape,
                                           torch.float32, False, 0.125,
                                           keypad_bias),
        0.125, False, 0.0, keep, [checks["bert_keypad"], checks["dense_d64"],
                                  checks["d128_causal_bias"]],
        _kernel_err, shape, FP32_TOLERANCE, kept=[int(x) for x in lens]))
    torch.cuda.empty_cache()
    return rows


def phase_flash_dropout(torch, np, F, K) -> dict:
    """The dropout mode (p = 0.1) of flash forward, dQ and dK/dV in bf16
    and fp32, with and without a bias, each kernel given the same key
    (seed, offset) as its plain version, so both draw the same Philox
    mask: fp32 at GPT-2's shape (causal) and at the padded BERT shape
    (key-padding mask), and a ragged causal [2, 1000, 4, 128], held by
    ``flash_fp32_errors``'s rule against fp64 with the same mask; bf16 at
    the same three shapes (the ragged d-128 one runs the d-128 dropout
    instantiations), held by ``_flash_errors``'s rule (the no-dropout
    modes' tolerances). Each kernel launched twice on one key must be
    bitwise equal, and the four dropout modes' launch counters must move.
    Times (``_mode_rows``) at GPT-2's shape without a bias and at the
    padded BERT shape with it; the yardstick is
    ``scaled_dot_product_attention`` with ``dropout_p`` and the mask, in
    the same dtype."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    seed = torch.tensor([SEED + 13, (1 << 31) + 5], dtype=torch.int64,
                        device="cuda")
    keep, lens = _keypad(torch, np, BERT_SEQ)
    bert_shape = (BERT_BATCH, BERT_SEQ, 12, 64)

    def keypad_bias(q, k):
        return F.attn_bias(keep.expand(BERT_BATCH, 1, BERT_SEQ, BERT_SEQ),
                           q, k)

    cases = [("fp32_gpt2", GPT2_SHAPE, torch.float32, True, None),
             ("fp32_bert_keypad", bert_shape, torch.float32, False,
              keypad_bias),
             ("fp32_d128_ragged", (2, 1000, 4, 128), torch.float32, True,
              None),
             ("bf16_gpt2", GPT2_SHAPE, torch.bfloat16, True, None),
             ("bf16_bert_keypad", bert_shape, torch.bfloat16, False,
              keypad_bias),
             ("bf16_d128_ragged", (2, 1000, 4, 128), torch.bfloat16, True,
              None)]
    K.reset_launch_counts()
    checks, repeat = {}, {}
    for name, shape, dtype, causal, bias_of in cases:
        q, k, v, do = _flash_inputs(torch, gen, shape, dtype)
        bias = None if bias_of is None else bias_of(q, k)
        scale = shape[3] ** -0.5
        mode = (bias, DROP_P, seed)
        if dtype == torch.float32:
            checks[name] = flash_fp32_errors(torch, F, q, k, v, do, scale,
                                             causal, *mode)
        else:
            checks[name] = _flash_errors(torch, F, q, k, v, do, scale,
                                         causal, *mode)
        o1, l1 = F.flash_fwd_cuda(q, k, v, scale, causal, *mode)
        o2, l2 = F.flash_fwd_cuda(q, k, v, scale, causal, *mode)
        delta = F.flash_delta(do, o1)
        g1 = (F.flash_bwd_dq_cuda(q, k, v, do, l1, delta, scale, causal,
                                  *mode),) + F.flash_bwd_dkv_cuda(
            q, k, v, do, l1, delta, scale, causal, *mode)
        g2 = (F.flash_bwd_dq_cuda(q, k, v, do, l1, delta, scale, causal,
                                  *mode),) + F.flash_bwd_dkv_cuda(
            q, k, v, do, l1, delta, scale, causal, *mode)
        repeat[name] = bool(torch.equal(o1, o2) and torch.equal(l1, l2)
                            and all(torch.equal(a, b_)
                                    for a, b_ in zip(g1, g2)))
        del q, k, v, do, bias, o1, o2, g1, g2
        torch.cuda.empty_cache()
    launches = K.launch_counts()
    _emit("flash_dropout_checks", {"checks": checks, "bitwise_repeat": repeat,
                                   "launches": launches})
    failures = {n: c["failures"] for n, c in checks.items() if c["failures"]}
    failures.update({n: "two launches on one key differ"
                     for n, ok in repeat.items() if not ok})
    idle = [n for n in ("flash_fwd_drop", "flash_dq_drop", "flash_dkv_drop",
                        "flash_fwd_drop_bias", "flash_dq_drop_bias",
                        "flash_dkv_drop_bias", "flash_fwd_fp32_drop",
                        "flash_dq_fp32_drop", "flash_dkv_fp32_drop",
                        "flash_fwd_fp32_drop_bias", "flash_dq_fp32_drop_bias",
                        "flash_dkv_fp32_drop_bias") if not launches[n]]
    if idle:
        failures["launch counters"] = f"no launch counted for {idle}"
    if failures:
        raise AssertionError(f"flash dropout kernels beyond tolerance: "
                             f"{failures}")
    rows = {}
    kept = [int(x) for x in lens]
    for suffix, dtype, shape, causal, bias_of, mask, names in (
            ("_fp32_drop", torch.float32, GPT2_SHAPE, True, None, None,
             ("fp32_gpt2", "fp32_d128_ragged")),
            ("_fp32_drop_bias", torch.float32, bert_shape, False,
             keypad_bias, keep, ("fp32_bert_keypad",)),
            ("_drop", torch.bfloat16, GPT2_SHAPE, True, None, None,
             ("bf16_gpt2", "bf16_d128_ragged")),
            ("_drop_bias", torch.bfloat16, bert_shape, False, keypad_bias,
             keep, ("bf16_bert_keypad",))):
        fp32 = dtype == torch.float32
        rows.update(_mode_rows(
            torch, F, suffix, _mode_sets(torch, F, gen, shape, dtype, causal,
                                         0.125, bias_of, DROP_P, seed),
            0.125, causal, DROP_P, mask, [checks[n] for n in names],
            _kernel_err if fp32 else (lambda e: e), shape,
            FP32_TOLERANCE if fp32 else BF16_TOLERANCE,
            kept=None if mask is None else kept, elt=4 if fp32 else 2,
            peak=FP32_ACCURATE_FLOPS if fp32 else BF16_TENSOR_FLOPS))
        torch.cuda.empty_cache()
    return rows

# ---- packed sequences (flash_attn_unpadded): the segment mode ----

VARLEN_ROW, VARLEN_BATCH = 2048, 4   # bench_llama's seq and batch
VARLEN_DOCS, VARLEN_VOCAB = 256, 32000
VARLEN_BF16 = (16, 128)              # the flagship's heads, bf16
VARLEN_FP32 = (12, 64)               # GPT-2 small's heads, fp32
# varlen_packed holds each document of the packed batch against that
# document alone through the no-segment kernels. bf16: each row within
# VARLEN_ROW_RTOL of its largest magnitude plus VARLEN_ROW_ATOL, each
# output within VARLEN_FRO in relative Frobenius norm: twice the bf16
# kernel-vs-plain rule, as both sides are kernels that round their
# outputs (and P, dS) to bf16 and each carries that rule's error against
# the same fp32 values, in other tilings. fp32: ``_rel_errors`` within
# VARLEN_FP32_ROW (worst row) and VARLEN_FP32_FRO: both sides lie within
# ~1e-6 of fp64 (flash_fp32). A document that saw another's keys would
# miss either by orders of magnitude.
VARLEN_ROW_RTOL, VARLEN_ROW_ATOL, VARLEN_FRO = 2 ** -6, 2e-3, 8e-3
VARLEN_FP32_ROW, VARLEN_FP32_FRO = 2 ** -14, 2 ** -16


def varlen_documents(np) -> list:
    """The documents of ``bench.py::bench_llama``'s first host step:
    256 documents of ``rng.integers(128, 2049)`` tokens drawn from
    ``default_rng(0)`` (bench.py:276-278), of which a host step packs
    ``2 * batch = 8``."""
    rng = np.random.default_rng(0)
    docs = [rng.integers(0, VARLEN_VOCAB, rng.integers(128, VARLEN_ROW + 1))
            .astype(np.int32) for _ in range(VARLEN_DOCS)]
    return docs[:2 * VARLEN_BATCH]


def varlen_pack(np, io, docs) -> tuple:
    """``docs`` packed into rows of 2048 by the port's ``pack_sequences``
    and the padding dropped: (tokens [total], cu_seqlens [n + 1]), the
    packer's per-row ``cu`` made the batch's."""
    rows, cu_rows = io.pack_sequences(docs, VARLEN_ROW)
    tokens, cu = [], [0]
    for row, c in zip(rows, cu_rows):
        bounds = c[c >= 0]
        tokens.append(row[:bounds[-1]])
        cu += [cu[-1] + int(x) for x in bounds[1:]]
    return np.concatenate(tokens), np.asarray(cu, np.int64)


def varlen_seg(np, F, cu_q, cu_k):
    """The segment ids ``flash_attn_unpadded`` makes of ``cu_seqlens``."""
    ids = [np.searchsorted(cu, np.arange(int(cu[-1])), side="right") - 1
           for cu in (cu_q, cu_k)]
    return F.seg_ids(ids[0], ids[1], "cuda"), ids


def _kept_pairs(cu_q, cu_k, causal) -> int:
    """(query, key) pairs a head that the segment mask (and, causal, the
    per-segment causal mask) keeps."""
    lq = [int(b) - int(a) for a, b in zip(cu_q[:-1], cu_q[1:])]
    lk = [int(b) - int(a) for a, b in zip(cu_k[:-1], cu_k[1:])]
    return sum(n * (n + 1) // 2 if causal else n * m for n, m in zip(lq, lk))


def _seg_bytes(sq, sk) -> int:
    """The segment ids (int32) and their int4 grain summaries."""
    grains = (sq + 31) // 32 + (sk + 31) // 32
    return 4 * (sq + sk) + 16 * grains


def _varlen_rows(torch, F, suffix, sets, scale, seg, cu, keep, shape, errs,
                 err_of, tolerance, elt, peak) -> dict:
    """Times of the segment mode's three kernels (``flash_{fwd,dq,dkv}``
    + ``suffix``, causal) on ``sets`` of ``(q, k, v, do, lse, delta)``
    ``[1, total, h, d]``: the kernels; their plain versions (the
    backward's computes dq, dk and dv together: one time for dQ and
    dK/dV); as yardsticks, one ``scaled_dot_product_attention`` call with
    the dense block-diagonal causal bool mask ``keep`` over ``[1, h,
    total, d]`` (``library``) and the loop of one
    ``scaled_dot_product_attention(is_causal=True)`` a document
    (``library_per_doc``), forward and backward through autograd; each
    beside its bound on the kept pairs at ``peak``."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    docs = [(int(a), int(b)) for a, b in zip(cu[:-1], cu[1:])]
    total, h, d = shape[1], shape[2], shape[3]
    pairs = _kept_pairs(cu, cu, True)

    def per_doc(qt, kt, vt):
        return [sdpa(qt[:, :, a:b], kt[:, :, a:b], vt[:, :, a:b],
                     is_causal=True) for a, b in docs]

    lib_fwd, lib_bwd, doc_bwd = [], [], []
    for a in sets:
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in a[:3])
        dot = a[3].transpose(1, 2)
        lib_fwd.append((qt, kt, vt))
        lib_bwd.append((sdpa(qt, kt, vt, attn_mask=keep), qt, kt, vt, dot))
        doc_bwd.append((per_doc(qt, kt, vt), qt, kt, vt,
                        [dot[:, :, a_:b_] for a_, b_ in docs]))

    def sdpa_fwd(qt, kt, vt):
        with torch.no_grad():
            return sdpa(qt, kt, vt, attn_mask=keep)

    def docs_fwd(qt, kt, vt):
        with torch.no_grad():
            return per_doc(qt, kt, vt)

    def grad(og, qt, kt, vt, dot):
        return torch.autograd.grad(og, (qt, kt, vt), dot, retain_graph=True)

    fns = {
        "fwd": {"kernel": lambda *a: F.flash_fwd_cuda(*a[:3], scale, True,
                                                       seg=seg),
                "plain": lambda *a: F.flash_fwd_plain(*a[:3], scale, True,
                                                       seg=seg),
                "library": sdpa_fwd, "library_per_doc": docs_fwd},
        "dq": {"kernel": lambda *a: F.flash_bwd_dq_cuda(*a[:6], scale, True,
                                                         seg=seg),
               "plain": lambda *a: F.flash_block_grads_plain(
                   *a[:6], scale, True, seg=seg),
               "library": grad, "library_per_doc": grad},
        "dkv": {"kernel": lambda *a: F.flash_bwd_dkv_cuda(*a[:6], scale,
                                                           True, seg=seg)},
    }
    outs = {"fwd": ("out",), "dq": ("dq",), "dkv": ("dk", "dv")}
    rows, bwd_times = {}, None
    for kind in ("fwd", "dq", "dkv"):
        flops, nbytes = _flash_work(1, total, total, h, d, True, kind,
                                    _seg_bytes(total, total), elt=elt,
                                    pairs=pairs)
        bound, bound_by = _bound(flops, nbytes, peak)
        own = ({"library": lib_fwd, "library_per_doc": lib_fwd}
               if kind == "fwd" else
               {"library": lib_bwd, "library_per_doc": doc_bwd})
        t = _timings(torch, fns[kind], sets, own)
        if kind == "dq":
            bwd_times = {k_: t[k_] for k_ in t if not k_.startswith(
                ("ms", "device_ms"))}
        elif kind == "dkv":
            t.update(bwd_times)
        name = f"flash_{kind}{suffix}"
        rows[name] = {
            "shape": list(shape), "causal": True, "segments": len(docs),
            "max_abs_err": max(err_of(e[o])["max_abs"] for e in errs
                               for o in outs[kind]),
            "errors_at_shape": {o: errs[0][o] for o in outs[kind]},
            "tolerance": tolerance, **t, "flops": flops, "bytes": nbytes,
            "kept_pairs_per_head": pairs, "bound_ms": bound,
            "bound_by": bound_by, "bound_peak_flops": peak}
        _emit("kernel_vs_plain", {"name": name, **rows[name]})
    del lib_fwd, lib_bwd, doc_bwd
    return rows


def phase_flash_varlen(torch, np, F, io) -> dict:
    """The segment mode of flash forward, dQ and dK/dV (packed sequences,
    ``flash_attn_unpadded``) against the plain versions given the same
    ids, on ``bench_llama``'s first packed host step: 8 documents of
    1762, 1490, 825, 1537, 558, 463, 297 and 1828 tokens (8,760 in all,
    not a multiple of any tile), as ``varlen_pack`` packs them.
    bf16 at the flagship's widths ([1, 8760, 16, 128]) causal and
    non-causal, by ``_flash_errors``'s rule; fp32 at GPT-2's heads ([1,
    8760, 12, 64]) causal, by ``flash_fp32_errors``'s rule against fp64;
    a non-causal cross-attention batch (bf16, d 128) whose key segments
    are half their query segments' lengths and segment 2 has none: its
    queries must give out 0 and lse -1e30. Times (``_varlen_rows``) for
    bf16 and fp32 causal beside the bound on the kept pairs, and the
    non-causal bf16 kernels' times."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    _, cu = varlen_pack(np, io, varlen_documents(np))
    total = int(cu[-1])
    seg, (ids, _) = varlen_seg(np, F, cu, cu)
    h, d = VARLEN_BF16
    scale = d ** -0.5
    checks = {}
    for name, causal in (("bf16_causal", True), ("bf16_noncausal", False)):
        q, k, v, do = _flash_inputs(torch, gen, (1, total, h, d),
                                    torch.bfloat16)
        checks[name] = _flash_errors(torch, F, q, k, v, do, scale, causal,
                                     seg=seg)
        del q, k, v, do
        torch.cuda.empty_cache()
    lens_k = np.diff(cu) // 2
    lens_k[2] = 0
    cu_k = np.concatenate([[0], np.cumsum(lens_k)])
    seg_x, _ = varlen_seg(np, F, cu, cu_k)
    q, _, _, do = _flash_inputs(torch, gen, (1, total, h, d), torch.bfloat16)
    _, k, v, _ = _flash_inputs(torch, gen, (1, int(cu_k[-1]), h, d),
                               torch.bfloat16)
    checks["bf16_cross"] = _flash_errors(torch, F, q, k, v, do, scale, False,
                                         seg=seg_x)
    out, lse = F.flash_fwd_cuda(q, k, v, scale, False, seg=seg_x)
    dead = torch.tensor(ids == 2, device="cuda")
    if not (bool((lse[:, :, dead] == F.NEG).all())
            and bool((lse[:, :, ~dead] > -1e29).all())
            and bool((out[:, dead] == 0).all())):
        checks["bf16_cross"]["failures"].append(
            "the queries of the keyless segment are not exactly dead")
    del q, k, v, do, out, lse
    torch.cuda.empty_cache()
    h32, d32 = VARLEN_FP32
    q, k, v, do = _flash_inputs(torch, gen, (1, total, h32, d32),
                                torch.float32)
    checks["fp32_causal"] = flash_fp32_errors(torch, F, q, k, v, do,
                                              d32 ** -0.5, True, seg=seg)
    del q, k, v, do
    torch.cuda.empty_cache()
    _emit("flash_varlen_checks", {"cu_seqlens": [int(x) for x in cu],
                                  "cu_seqlens_k_cross":
                                  [int(x) for x in cu_k], **checks})
    failures = {n: c["failures"] for n, c in checks.items() if c["failures"]}
    if failures:
        raise AssertionError(f"flash segment-mode kernels beyond tolerance: "
                             f"{failures}")
    idt = torch.tensor(ids, device="cuda")
    pos = torch.arange(total, device="cuda")
    keep = (idt[:, None] == idt[None, :]) & (pos[:, None] >= pos[None, :])
    rows = {}
    for suffix, (hh, dd), dtype, names, err_of, tol, elt, peak in (
            ("_seg", VARLEN_BF16, torch.bfloat16, ("bf16_causal",
                                                  "bf16_noncausal",
                                                  "bf16_cross"),
             lambda e: e, BF16_TOLERANCE, 2, BF16_TENSOR_FLOPS),
            ("_fp32_seg", VARLEN_FP32, torch.float32, ("fp32_causal",),
             _kernel_err, FP32_TOLERANCE, 4, FP32_ACCURATE_FLOPS)):
        sets = []
        for _ in range(3):
            q, k, v, do = _flash_inputs(torch, gen, (1, total, hh, dd), dtype)
            out, lse = F.flash_fwd_cuda(q, k, v, dd ** -0.5, True, seg=seg)
            sets.append((q, k, v, do, lse, F.flash_delta(do, out)))
        rows.update(_varlen_rows(
            torch, F, suffix, sets, dd ** -0.5, seg, cu, keep,
            (1, total, hh, dd), [checks[n] for n in names], err_of, tol,
            elt, peak))
        if suffix == "_seg":     # the non-causal mode, kernels only
            pairs = _kept_pairs(cu, cu, False)
            nc = {}
            for kind, fn in (
                    ("fwd", lambda *a: F.flash_fwd_cuda(
                        *a[:3], scale, False, seg=seg)),
                    ("dq", lambda *a: F.flash_bwd_dq_cuda(
                        *a[:6], scale, False, seg=seg)),
                    ("dkv", lambda *a: F.flash_bwd_dkv_cuda(
                        *a[:6], scale, False, seg=seg))):
                flops, nbytes = _flash_work(1, total, total, hh, dd, False,
                                            kind, _seg_bytes(total, total),
                                            pairs=pairs)
                nc[kind] = {**_timings(torch, {"kernel": fn}, sets),
                            "bound_ms": _bound(flops, nbytes)[0],
                            "kept_pairs_per_head": pairs}
            _emit("flash_varlen_noncausal", nc)
        del sets
        torch.cuda.empty_cache()
    del keep
    torch.cuda.empty_cache()
    return rows


def _doc_errors(torch, got, want, fp32) -> tuple:
    """(worst row over its tolerance, relative Frobenius error) of a
    packed document's output or gradient against the document alone."""
    if fp32:
        e = _rel_errors(torch, got, want.double())
        return e["row"] / VARLEN_FP32_ROW, e["fro"] / VARLEN_FP32_FRO
    diff = got.float() - want.float()
    tol = VARLEN_ROW_RTOL * want.float().abs().amax(-1) + VARLEN_ROW_ATOL
    fro = (diff.norm() / want.float().norm().clamp(min=1e-30)).item()
    return (diff.abs().amax(-1) / tol).max().item(), fro / VARLEN_FRO


def phase_varlen_packed(torch, np, K, F, io, TF, TI) -> dict:
    """The slice's path through its public entry points: the port's
    native ``pack_sequences`` (its C++ library must have built:
    ``native_available()``) packs ``bench_llama``'s first host step into
    rows of 2048; the rows' ``cu`` become the batch's ``cu_seqlens``
    (8,760 tokens, 8 documents); then ``nn.functional.
    flash_attn_unpadded`` forward and backward through autograd at
    [8760, 16, 128] bf16 causal, ``incubate.nn.functional.
    variable_length_memory_efficient_attention`` non-causal at the same
    widths, and ``flash_attn_unpadded`` in fp32 at [8760, 12, 64] causal.
    The launch counters, read around these calls alone, must be exactly
    theirs (the segment mode: bf16 2 of each kernel, fp32 1). Then each
    document's output and q, k and v gradients are held against
    ``flash_attention`` on that document alone ([1, len, h, d], the
    no-segment kernels, whose 16 bf16 and 8 fp32 launches of each kernel
    are counted apart): ``VARLEN_*`` limits. Last, for information, CUDA
    event times of the packed bf16 causal call (forward and backward)
    against the 8 per-document calls."""
    if not io.native_available():
        raise AssertionError("the C++ sequence packer did not build: "
                             "pack_sequences would take its numpy path")
    docs = varlen_documents(np)
    t0 = time.perf_counter()
    tokens, cu = varlen_pack(np, io, docs)
    pack_ms = (time.perf_counter() - t0) * 1e3
    if not np.array_equal(tokens, np.concatenate(docs)):
        raise AssertionError("packing and unpadding changed the tokens")
    total = int(cu[-1])
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)

    def arm(h, d, dtype):
        q, k, v, dout = _flash_inputs(torch, gen, (total, h, d), dtype)
        return [x.requires_grad_(True) for x in (q, k, v)], dout

    arms = {"bf16_causal": (*arm(*VARLEN_BF16, torch.bfloat16), True),
            "bf16_noncausal": (*arm(*VARLEN_BF16, torch.bfloat16), False),
            "fp32_causal": (*arm(*VARLEN_FP32, torch.float32), True)}
    outs = {}
    K.reset_launch_counts()
    for name, (leaves, dout, causal) in arms.items():
        if name == "bf16_noncausal":
            out = TI.variable_length_memory_efficient_attention(
                *leaves, cu, cu, causal=False)
        else:
            out = TF.flash_attn_unpadded(*leaves, cu, cu, causal=causal)
        out.backward(dout)
        outs[name] = out.detach()
    torch.cuda.synchronize()
    launches = K.launch_counts()
    want = _counts(K, flash_fwd_seg=2, flash_dq_seg=2, flash_dkv_seg=2,
                   flash_fwd_fp32_seg=1, flash_dq_fp32_seg=1,
                   flash_dkv_fp32_seg=1)
    failures = []
    if launches != want:
        failures.append(f"launches {launches} != {want}")
    K.reset_launch_counts()
    errors = {}
    for name, (leaves, dout, causal) in arms.items():
        worst = {}
        for a, b in zip(cu[:-1], cu[1:]):
            alone = [x.detach()[a:b][None].clone().requires_grad_(True)
                     for x in leaves]
            o = F.flash_attention(*alone, causal=causal)
            o.backward(dout[a:b][None])
            for what, got, ref in zip(
                    ("out", "dq", "dk", "dv"),
                    (outs[name][a:b],) + tuple(x.grad[a:b] for x in leaves),
                    (o.detach()[0],) + tuple(x.grad[0] for x in alone)):
                r, f = _doc_errors(torch, got, ref, name.startswith("fp32"))
                w = worst.setdefault(what, {"row": 0.0, "fro": 0.0})
                w["row"], w["fro"] = max(w["row"], r), max(w["fro"], f)
        errors[name] = worst
        failures += [f"{name} {what}: {m} at {v:.3g} of its limit"
                     for what, w in worst.items() for m, v in w.items()
                     if not v <= 1.0]
    torch.cuda.synchronize()
    ref_launches = K.launch_counts()
    want_ref = _counts(K, flash_fwd=16, flash_dq=16, flash_dkv=16,
                       flash_fwd_fp32=8, flash_dq_fp32=8, flash_dkv_fp32=8)
    if ref_launches != want_ref:
        failures.append(f"reference launches {ref_launches} != {want_ref}")
    (leaves, dout, _), docs_cu = arms["bf16_causal"], list(zip(cu[:-1],
                                                              cu[1:]))

    def packed():
        TF.flash_attn_unpadded(*leaves, cu, cu, causal=True).backward(dout)

    def per_doc():
        for a, b in docs_cu:
            F.flash_attention(*(x[a:b][None] for x in leaves),
                              causal=True).backward(dout[a:b][None])

    times = {"packed_fwd_bwd_ms": _time_ms(torch, packed, [()], iters=20,
                                           warmup=3),
             "per_doc_fwd_bwd_ms": _time_ms(torch, per_doc, [()], iters=20,
                                            warmup=3)}
    result = {"native_packer": True, "pack_host_ms": pack_ms,
              "cu_seqlens": [int(x) for x in cu], "tokens": total,
              "launches": launches, "reference_launches": ref_launches,
              "errors_over_limit": errors, "limits": {
                  "bf16": [VARLEN_ROW_RTOL, VARLEN_ROW_ATOL, VARLEN_FRO],
                  "fp32": [VARLEN_FP32_ROW, VARLEN_FP32_FRO]},
              **times, "failures": failures}
    _emit("varlen_packed", result)
    if failures:
        raise AssertionError(f"varlen_packed: {failures}")
    return result


def flagship_config(LlamaConfig, seq: int):
    """The JAX package's one-chip training configuration,
    ``bench.py::_llama_flagship`` (bench.py:245-263): full width and
    depth, bf16, no recompute."""
    return LlamaConfig(vocab_size=32000, hidden_size=2048,
                       intermediate_size=5632, num_hidden_layers=8,
                       num_attention_heads=16, num_key_value_heads=8,
                       max_position_embeddings=seq, dtype="bfloat16",
                       mp_axis=None, fsdp_axis=None, recompute=False)


TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 4, 2048, 10, 1e-4


def phase_train(torch, K, model, TrainStep, AdamW, batch, smi) -> tuple:
    """10 TrainSteps on one fixed batch (labels = inputs, shifted by the
    loss, as bench.py feeds it): per-step wall time (host clock around a
    step that ends in a synchronise), the median after 2 warm-up steps,
    tokens/s, MFU with the bench's FLOPs per token ``6 N + 12 L s h``
    (bench.py:262) over the 989 TFLOP/s bf16 peak, peak memory, every
    loss, and the launch counters of this phase alone."""
    cfg = model.config
    L, S, H = cfg.num_hidden_layers, TRAIN_SEQ, cfg.hidden_size
    opt = AdamW(learning_rate=TRAIN_LR, parameters=model)
    step = TrainStep(model, opt, lambda logits, y: model.loss(logits, y))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = step(batch, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    launches = K.launch_counts()
    n_params = model.num_params()
    step_s = statistics.median(times[2:])
    tokens = TRAIN_BATCH * S
    fpt = 6.0 * n_params + 12.0 * L * S * H
    out = {"config": cfg.__dict__, "params": n_params,
           "batch": TRAIN_BATCH, "seq": S, "lr": TRAIN_LR,
           "step_ms": [t * 1e3 for t in times],
           "median_step_ms": step_s * 1e3,
           "tokens_per_s": tokens / step_s,
           "mfu": fpt * tokens / step_s / BF16_TENSOR_FLOPS,
           "flops_per_token": fpt,
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "losses": losses, "launches": launches, "card": smi}
    _emit("train", out)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall on a fixed batch: "
                             f"{losses}")
    want = _counts(K, rms_norm=(2 * L + 1) * TRAIN_STEPS,
                   flash_fwd=L * TRAIN_STEPS, flash_dq=L * TRAIN_STEPS,
                   flash_dkv=L * TRAIN_STEPS)
    if launches != want:
        raise AssertionError(f"launch counters {launches} != expected "
                             f"{want} over {TRAIN_STEPS} steps")
    return out, opt


def _clone_state(state):
    if isinstance(state, dict):
        return {k: _clone_state(v) for k, v in state.items()}
    return state.clone() if hasattr(state, "clone") else state


# Train parity limits (see train_parity_run)
PARITY_DLOSS, PARITY_GRAD_REL, PARITY_DPARAM = 2e-3, 0.05, 1.5e-4
UNRESOLVED_RATIO = 2.0


FLASH_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")


def causal_lm_args(model, batch) -> tuple:
    """A causal LM's ``train_parity_run`` step: ``model.loss`` on
    ``(batch, batch)`` (labels = inputs, shifted by the loss)."""
    return (lambda logits, y: model.loss(logits, y)), (batch, batch)


def train_parity_run(torch, K, model, opt, TrainStep, loss_fn, args,
                     n_inputs=1, kernels=FLASH_KERNELS,
                     limits=(PARITY_DLOSS, PARITY_GRAD_REL, PARITY_DPARAM),
                     reseed=None, probes=(), probe_limits=None,
                     grad_ref=None, unresolved_ratio=UNRESOLVED_RATIO,
                     plain_first=False) -> dict:
    """Three steps from one state (weights and optimizer state cloned)
    through the kernels, then the same three inside plain_reference().

    Tolerances, each with its reason. Both runs are deterministic (no
    atomics in any kernel), so the correct kernels give the same
    differences every run: |loss difference| 3.5e-4 at most over the
    three steps, the first step's gradients 0.023 in relative L2 at
    most (``layers.7.self_attn.q_proj.weight``: the dQ kernel rounds dS
    to bf16, and dq = dS K cancels most of its terms), the fp32 master
    weights 2.8e-5 apart after step 3 (PERF.md). The limits stand a few
    times above those: per-step |loss difference| <= 2e-3, every
    gradient <= 0.05 in relative L2, max |master difference| <= 1.5e-4
    (a quarter of the 6.1e-4 that three Adam steps at lr 1e-4 can put
    between two runs). ``chip_mutants.py`` plants faults in the kernels
    and shows which of these limits each one breaks. Returns the
    measurements and ``failures``, a list of the limits broken.

    The step is ``TrainStep(model, opt, loss_fn, n_inputs)`` called on
    ``args`` (``causal_lm_args`` gives a causal LM's). ``kernels`` must
    launch in the kernel run; ``limits`` are the three limits above;
    ``reseed``, when given, is called before each run (a model that
    draws random numbers starts both runs from one state). ``probes``
    names modules whose output and input gradient in the first step are
    compared too (relative L2, the worst module against ``probe_limits =
    (output, input gradient)``). ``plain_first`` runs the plain steps
    before the kernel steps.

    ``grad_ref``, when given, holds the first step's gradients of an fp32
    copy of the model, through the plain versions, from the same
    weights. A parameter whose plain bf16 gradient lies more than half
    the gradient limit from it in relative L2 (``bf16_noise``) is one
    that bf16 cannot resolve to that limit, so two bf16 runs cannot be
    held to it either: such a parameter (``unresolved``) is held instead
    to lie no more than ``unresolved_ratio`` (``UNRESOLVED_RATIO``) times
    as far from the fp32 gradient as the plain version's gradient does,
    and is left out of
    the master-weight limit, since Adam turns a gradient of rounding
    noise into steps of +-lr whatever its size. Every other parameter
    stays under all three limits."""
    params = dict(model.named_parameters())
    snap_p = {k: p.detach().clone() for k, p in params.items()}
    snap_s = _clone_state(opt.state)
    runs, seen = {}, {}

    def record(mod_name, kind, value):      # the first step's only
        if value is not None and kind not in seen[mod_name]:
            seen[mod_name][kind] = value.detach().float().clone()

    hooks = []
    for mod_name, mod in probes:
        hooks.append(mod.register_forward_hook(
            lambda m, i, o, n=mod_name: record(n, "out", o)))
        hooks.append(mod.register_full_backward_hook(
            lambda m, gi, go, n=mod_name: record(n, "dx", gi[0])))
    for name in (("plain", "kernels") if plain_first
                 else ("kernels", "plain")):
        seen = {mod_name: {} for mod_name, _ in probes}
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(snap_p[k])
        opt.state = _clone_state(snap_s)
        if reseed is not None:
            reseed()
        step = TrainStep(model, opt, loss_fn, n_inputs=n_inputs)
        K.reset_launch_counts()
        scope = (K.plain_reference() if name == "plain"
                 else contextlib.nullcontext())
        losses, grads = [], None
        with scope:
            for i in range(3):
                losses.append(step(*args).item())
                if i == 0:
                    grads = {k: p.grad.detach().clone()
                             for k, p in params.items()}
        torch.cuda.synchronize()
        master = {k: (opt.state["master"][k] if opt.state["master"][k]
                      is not None else params[k]).detach().clone()
                  for k in params}
        runs[name] = (losses, grads, master, K.launch_counts(), seen)
    for h in hooks:
        h.remove()
    (lk, gk, mk, ck, pk), (lp, gp, mp, cp, pp) = (runs["kernels"],
                                                  runs["plain"])
    lim_loss, lim_grad, lim_param = limits
    dloss = [abs(a - b) for a, b in zip(lk, lp)]
    noise, unresolved = {}, {}
    for k, ref in (grad_ref or {}).items():
        ref_norm = max(ref.norm().item(), 1e-30)
        noise[k] = (gp[k].float() - ref).norm().item() / ref_norm
        if noise[k] > lim_grad / 2:
            unresolved[k] = ((gk[k].float() - ref).norm().item() / ref_norm
                             / noise[k])
    grad_rel = {k: (gk[k].float() - gp[k].float()).norm().item()
                / max(gp[k].float().norm().item(), 1e-30)
                for k in gk if k not in unresolved}
    dparam = max((mk[k] - mp[k]).abs().max().item() for k in mk
                 if k not in unresolved)
    worst = max(grad_rel, key=grad_rel.get)
    failures = []
    if any(cp.values()) or not all(ck[n] for n in kernels):
        failures.append(f"the kernel run must launch {kernels} and the "
                        f"plain run none: {ck} {cp}")
    if not max(dloss) <= lim_loss:
        failures.append(f"|loss difference| {max(dloss)} > {lim_loss}")
    if not grad_rel[worst] <= lim_grad:
        failures.append(f"gradient {worst} {grad_rel[worst]} > "
                        f"{lim_grad} in relative L2")
    if not dparam <= lim_param:
        failures.append(f"master weights {dparam} > {lim_param} apart")
    if unresolved:
        worst_u = max(unresolved, key=unresolved.get)
        if not unresolved[worst_u] <= unresolved_ratio:
            failures.append(f"gradient {worst_u} lies {unresolved[worst_u]}"
                            f" times as far from fp32 as the plain "
                            f"version's > {unresolved_ratio}")
    probe_rel = {kind: {n: ((pk[n][kind] - pp[n][kind]).norm()
                            / pp[n][kind].norm().clamp(min=1e-30)).item()
                        for n in pk} for kind in ("out", "dx")}
    for kind, lim in zip(("out", "dx"), probe_limits or ()):
        worst_n = max(probe_rel[kind], key=probe_rel[kind].get)
        if not probe_rel[kind][worst_n] <= lim:
            failures.append(f"{worst_n} {kind} {probe_rel[kind][worst_n]} "
                            f"> {lim} in relative L2")
    worst_p = max((k for k in mk if k not in unresolved),
                  key=lambda k: (mk[k] - mp[k]).abs().max().item())
    return {"losses_kernels": lk, "losses_plain": lp, "abs_dloss": dloss,
            "worst_dparam": worst_p,
            "max_grad_rel_l2": grad_rel[worst], "worst_grad": worst,
            "top_grad_rel_l2": sorted(grad_rel.items(),
                                      key=lambda kv: -kv[1])[:8],
            "unresolved": unresolved, "bf16_noise": noise,
            "grad_rel_l2": grad_rel, "max_abs_dparam_step3": dparam,
            "launches_kernels": ck, "launches_plain": cp,
            "probe_rel_l2": probe_rel, "failures": failures}


def phase_train_parity(torch, K, model, opt, TrainStep, batch) -> dict:
    out = train_parity_run(torch, K, model, opt, TrainStep,
                           *causal_lm_args(model, batch))
    _emit("train_parity", {k: v for k, v in out.items()
                           if k != "grad_rel_l2"})
    if out["failures"]:
        raise AssertionError(f"train parity beyond tolerance: "
                             f"{out['failures']}")
    return out


def _profile_steps(torch, fn, n_steps, top=10) -> dict:
    """``n_steps`` calls of ``fn`` under ``torch.profiler`` (device
    activity only): host wall per step (profiler on), summed device time,
    the device's idle share, and the ``top`` kernels with the most device
    time (all of them, under ``all_kernels_ms``, when ``top`` is None)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    by_name: dict[str, float] = {}
    device = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) \
            + e.time_range.elapsed_us()
    busy_ms = sum(by_name.values()) / 1e3 / n_steps
    ranked = [[k, us / 1e3 / n_steps] for k, us in
              sorted(by_name.items(), key=lambda kv: -kv[1])]
    out = {"wall_ms": wall_ms,
           "device_ms": busy_ms if busy_ms > 0 else None,
           "idle_share": 1 - busy_ms / wall_ms if busy_ms > 0 else None,
           "top_kernels_ms": [[k[:90], ms] for k, ms in ranked[:10]]}
    if top is None:
        out["all_kernels_ms"] = ranked
        out["kernel_sequence"] = [e.name for e in device]
    return out


_CATEGORIES = (("flash", ("flash_",)), ("rms_norm", ("rms_norm",)),
               ("gemm", ("nvjet", "gemm", "xmma", "cutlass", "cublas")))


def phase_train_profile(torch, model, opt, TrainStep, batch,
                        fwd_mode=None) -> dict:
    """Where a training step's time goes: one step under the profiler,
    its device time by kernel category (flash kernels, RMSNorm kernel,
    GEMMs, everything else: elementwise, casts, reductions, the loss and
    the optimizer), the flash kernels that ran, and the optimizer update
    alone, timed by CUDA events on that step's gradients. ``fwd_mode``
    (``"<128, false, false>"``), when given: the step's flash forward must be the
    wgmma kernel of that mode alone (``check_wgmma_forward``)."""
    step = TrainStep(model, opt, lambda logits, y: model.loss(logits, y))
    out = _profile_steps(torch, lambda: step(batch, batch), 1, top=None)
    cats = {name: 0.0 for name, _ in _CATEGORIES}
    cats["other"] = 0.0
    ranked = out.pop("all_kernels_ms")
    out["flash_fwd_kernels"] = flash_fwd_kernels(k_ for k_, _ in ranked)
    out["flash_bwd_kernels"] = flash_bwd_kernels(k_ for k_, _ in ranked)
    for kname, ms in ranked:
        cat = next((name for name, keys in _CATEGORIES
                    if any(k_ in kname for k_ in keys)), "other")
        cats[cat] += ms
    out["device_ms_by_category"] = cats
    params = dict(model.named_parameters())
    grads = {k: p.grad for k, p in params.items()}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    opt.update(params, grads, opt.state, lr=opt.get_lr())
    end.record()
    torch.cuda.synchronize()
    out["optimizer_update_ms"] = start.elapsed_time(end)
    _emit("train_profile", out)
    if fwd_mode is not None:
        check_wgmma_forward("train_profile", out, fwd_mode)
    return out


# ---------------- the Qwen2-MoE training path ----------------

def moe_config(Qwen2MoeConfig, seq: int):
    """The JAX package's ``qwen2_moe_fused`` configuration
    (``bench.py::bench_qwen2_moe``, bench.py:451-457, with
    ``ep_dispatch="fused"`` as bench.py:2883 calls it): full width and
    depth, bf16, every layer sparse."""
    return Qwen2MoeConfig(vocab_size=32000, hidden_size=1024,
                          intermediate_size=2816, moe_intermediate_size=704,
                          shared_expert_intermediate_size=2816,
                          num_hidden_layers=8, num_attention_heads=16,
                          num_key_value_heads=8, num_experts=16,
                          num_experts_per_tok=2, max_position_embeddings=seq,
                          dtype="bfloat16", ep_dispatch="fused")


def moe_fp32_config(Qwen2MoeConfig, seq: int):
    """``moe_config`` in fp32 (``Qwen2MoeConfig``'s own default dtype,
    ``paddle_tpu/models/qwen2_moe.py:49``) with the expert width cut
    from 704 to ``MOE_FP32_H``: at T 8192 the JAX package's fused gate
    (``moe_grouped_gemm.py:116``, its VMEM term 20 D H + 1 MiB <= 14 MiB
    at D 1024) rejects fp32 at 704 and admits it at 512, so neither
    package runs the fp32 grouped kernels at 704. Every other field is
    ``moe_config``'s: full width elsewhere and full depth."""
    cfg = moe_config(Qwen2MoeConfig, seq)
    return dataclasses.replace(cfg, dtype="float32",
                               moe_intermediate_size=MOE_FP32_H)


MOE_BATCH, MOE_SEQ, MOE_STEPS = 8, 1024, 10
MOE_KERNELS = ("moe_routing", "moe_fwd", "moe_dx", "moe_dw")
# Routing kernel vs plain: a row's decisions (experts, keep2) may differ
# only where its top-2 or keep2 margin is below ROUTE_MARGIN (two fp32
# softmaxes whose sums run in another order); g1, g2 within ROUTE_ATOL;
# me_sum within ROUTE_ME_RTOL (8192 fp32 terms summed in another order).
ROUTE_MARGIN, ROUTE_ATOL, ROUTE_ME_RTOL = 1e-6, 1e-6, 1e-5


def _row_errors(torch, got, want) -> dict:
    """``got`` against fp32 ``want`` by rows of the last axis: the worst
    row's error over ``2**-7`` of that row's largest magnitude + 1e-3
    (``row``), the relative Frobenius error (``fro``), and the largest
    absolute error."""
    diff = got.float() - want
    row_tol = FLASH_ROW_RTOL * want.abs().amax(-1) + FLASH_ROW_ATOL
    return {"max_abs": diff.abs().max().item(),
            "row": (diff.abs().amax(-1) / row_tol).max().item(),
            "fro": (diff.norm() / want.norm().clamp(min=1e-30)).item()}


def _fails(name, err) -> list[str]:
    out = []
    if not err["row"] <= 1.0:
        out.append(f"{name}: a row beyond its tolerance ({err['row']:.3g}x)")
    if not err["fro"] <= FLASH_FRO:
        out.append(f"{name}: relative Frobenius error {err['fro']:.3g} > "
                   f"{FLASH_FRO}")
    return out


def _positions(torch, g1i, g2i, keep2, E):
    """p1, c2 and count1 from routing decisions: the plain scan."""
    iota = torch.arange(E, device=g1i.device)
    m1 = (g1i.long()[:, None] == iota).int()
    m2 = (g2i.long()[:, None] == iota).int() * keep2.int()[:, None]
    p1 = ((torch.cumsum(m1, 0) - 1) * m1).sum(1).int()
    c2 = ((torch.cumsum(m2, 0) - 1) * m2).sum(1).int()
    return p1, c2, m1.sum(0).float()


def _route_margin(torch, logits, u):
    """Per row: the smallest gap among its three largest probabilities
    and between u and its keep threshold."""
    p = torch.softmax(logits.float(), dim=-1).topk(3, dim=-1).values
    thr = 2 * p[:, 1] / torch.clamp(p[:, 0] + p[:, 1], min=1e-9)
    return torch.stack([p[:, 0] - p[:, 1], p[:, 1] - p[:, 2],
                        (u - thr).abs()]).amin(0)


def routing_errors(torch, MR, logits, u) -> dict:
    """The routing kernel against its plain version on the same logits
    and uniforms (see ROUTE_MARGIN); a second launch must be bitwise
    equal to the first. Returns the measurements and ``failures``."""
    got = MR.moe_routing_cuda(logits, u, True)
    again = MR.moe_routing_cuda(logits, u, True)
    torch.cuda.synchronize()
    want = MR.routing_plain(logits, u, True)
    g1i, g2i, g1, g2, p1, c2, keep2, count1, me_sum = got
    E = logits.shape[1]
    failures = []
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        failures.append("routing: a second launch differs")
    differ = ((g1i != want[0]) | (g2i != want[1]) | (keep2 != want[6]))
    margin = _route_margin(torch, logits, u)
    n_differ = int(differ.sum())
    worst_margin = margin[differ].max().item() if n_differ else 0.0
    if n_differ and not worst_margin < ROUTE_MARGIN:
        failures.append(f"routing: {n_differ} rows decide otherwise, one "
                        f"with margin {worst_margin} >= {ROUTE_MARGIN}")
    # the positions are a function of the decisions: exact, from the
    # kernel's own decisions
    wp1, wc2, wcount = _positions(torch, g1i, g2i, keep2, E)
    if not (torch.equal(p1, wp1) and torch.equal(c2, wc2)
            and torch.equal(count1, wcount)):
        failures.append("routing: positions or counts differ from the scan "
                        "of the kernel's own decisions")
    same = ~differ
    errs = {"g1": (g1 - want[2])[same].abs().max().item(),
            "g2": (g2 - want[3])[same].abs().max().item(),
            "me_sum": ((me_sum - want[8]).abs()
                       / want[8].abs().clamp(min=1e-30)).max().item()}
    if not max(errs["g1"], errs["g2"]) <= ROUTE_ATOL:
        failures.append(f"routing: g1/g2 differ by {errs} > {ROUTE_ATOL}")
    if not errs["me_sum"] <= ROUTE_ME_RTOL:
        failures.append(f"routing: me_sum differs by {errs['me_sum']} > "
                        f"{ROUTE_ME_RTOL} relative")
    if n_differ == 0 and not all(torch.equal(a, b) for a, b in
                                 zip(got[:2] + got[4:7], want[:2] + want[4:7])):
        failures.append("routing: integer outputs differ")
    return {"rows_deciding_otherwise": n_differ,
            "their_largest_margin": worst_margin,
            "max_abs_err": max(errs["g1"], errs["g2"]),
            "errors": errs, "failures": failures}


def moe_errors(torch, GG, x, row_id, gate_w, wi, wg, wo, g,
               act="silu") -> dict:
    """Each grouped-GEMM kernel against its plain version on the same
    inputs (dW from the kernel's own dX intermediates, so each kernel is
    held alone), by ``_row_errors`` with the flash rule; each kernel
    launched twice must give bitwise equal results. The dgw and h of an
    empty slot are not compared: the Pallas kernels compute them from
    row T - 1, the CUDA kernels leave 0. ``act`` "relu" runs the ungated
    FFN (``wg`` unused)."""
    if act == "relu":
        wg = None
    out = GG.moe_fwd_cuda(x, row_id, gate_w, wi, wg, wo, act)
    out2 = GG.moe_fwd_cuda(x, row_id, gate_w, wi, wg, wo, act)
    dx, dgw, inter = GG.moe_dx_cuda(x, row_id, gate_w, wi, wg, wo, g, act)
    dx2, dgw2, inter2 = GG.moe_dx_cuda(x, row_id, gate_w, wi, wg, wo, g,
                                       act)
    dws = GG.moe_dw_cuda(x, row_id, gate_w, g, inter)
    dws2 = GG.moe_dw_cuda(x, row_id, gate_w, g, inter)
    torch.cuda.synchronize()
    occupied = (row_id < x.shape[0]).float()
    failures = []
    repeat = {"fwd": torch.equal(out, out2),
              "dx": torch.equal(dx, dx2) and torch.equal(dgw * occupied,
                                                         dgw2 * occupied),
              "dw": all(a is None and b is None or torch.equal(a, b)
                        for a, b in zip(dws, dws2))}
    failures += [f"{k}: a second launch differs" for k, v in repeat.items()
                 if not v]
    errs = {}
    want = GG.moe_fwd_plain(x, row_id, gate_w, wi, wg, wo, act)
    errs["out"] = _row_errors(torch, out, want)
    del want
    wdx, wdgw, winter = GG.moe_dx_plain(x, row_id, gate_w, wi, wg, wo, g,
                                        act)   # winter: h rounded
    errs["dx"] = _row_errors(torch, dx, wdx)
    errs["dgw"] = _row_errors(torch, dgw * occupied, wdgw * occupied)
    del winter
    want_h = GG._forward_parts(x, row_id, wi, wg, act)[3]   # fp32
    errs["h"] = _row_errors(torch, inter[0] * occupied[..., None],
                            want_h * occupied[..., None])
    del wdx, wdgw, want_h
    for name, got, want in zip(("dw_in", "dw_gate", "dw_out"), dws,
                               GG.moe_dw_plain(x, row_id, gate_w, g, inter)):
        if want is not None:
            errs[name] = _row_errors(torch, got, want)
    for name, err in errs.items():
        failures += _fails(name, err)
    return {"errors": errs, "bitwise_repeat": repeat, "failures": failures}


def moe_inputs(torch, GG, MR, gen, T=MOE_BATCH * MOE_SEQ, E=16, D=1024,
               H=704, dtype="bfloat16", cap=None, hot=False):
    """Inputs of the MoE kernels at the training path's shapes: fp32
    logits ~ N(0, 1.5^2) (the router's scale at init) plus a per-expert
    offset rising from 0 to 1.5, so that, as in training, some experts
    fill their capacity (at T 8192: 4 of 16 full, 3410 of 16384 copies
    dropped) and every slot block is exercised; uniforms; the slot maps
    they route to (the plain routing and the fused dispatch's own
    packing, capacity 1280); x and g ~ N(0, 1) and weights ~ N(0, 1/K)
    for a product over K, so every product is O(1) and the tolerances'
    1e-3 absolute term is small beside it; all in ``dtype`` but the
    logits. ``cap`` overrides the capacity; ``hot`` raises expert 0's
    logit by 50, so that it takes every token's first copy (up to its
    capacity) and the second copies are dropped (keep threshold ~e^-50):
    the other experts hold no token."""
    from paddle_tpu_torch.distributed import moe as M
    logits = (torch.randn((T, E), generator=gen, device="cuda") * 1.5
              + torch.linspace(0.0, 1.5, E, device="cuda"))
    if hot:
        logits[:, 0] += 50.0
    u = torch.rand((T,), generator=gen, device="cuda")
    cap = int(1.25 * T * 2 / E) if cap is None else cap
    with torch.no_grad():
        parts = M._top2_parts(logits, cap, u=u)
        idx = torch.stack(parts[:2], 1)
        w = torch.stack(parts[2:4], 1)
        keep = torch.stack(parts[4:6], 1)
        pos = torch.stack(parts[6:8], 1)
        cpad = GG.padded_capacity(cap)
        slot, _, fill, occ = M._slot_structures(idx, pos, keep, E, cpad)
        row_id, gate_w = GG.slot_maps(slot, fill, occ, w.reshape(-1), T, E,
                                      cpad, 2)

    def rand(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * std).to(getattr(torch, dtype))

    return {"logits": logits, "u": u, "row_id": row_id.contiguous(),
            "gate_w": gate_w.contiguous(), "x": rand(T, D),
            "g": rand(T, D), "wi": rand(E, D, H, std=D ** -0.5),
            "wg": rand(E, D, H, std=D ** -0.5),
            "wo": rand(E, H, D, std=H ** -0.5), "capacity": cap,
            "cpad": cpad, "occupied": int((row_id < T).sum())}


def _short_kernel_name(name: str) -> str:
    """A profiler kernel name without its return type, namespace and
    parameters: ``void (anonymous namespace)::f<int>(int*)`` -> ``f<int>``."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0]
    return name.removeprefix("void ").strip()[:60]


# The grouped kernels' edges, small: (T, E, D, H, capacity, act, hot). A
# capacity of 38 (cpad 40, not a multiple of the 128-slot block) with the
# ungated relu FFN; one expert holding every token (``hot``) and three
# holding none, so whole 128-slot blocks are empty, at H 704 (11 tiles of
# 64, not a power of 2) and D 256.
MOE_EDGES = ((1024, 16, 128, 96, 38, "relu", False),
             (1024, 4, 256, 704, 1024, "silu", True))


def moe_edge_errors(torch, GG, MR, gen) -> list:
    """``moe_errors`` on each of ``MOE_EDGES``, inputs from ``gen``."""
    out = []
    for T, E, D, H, cap, act, hot in MOE_EDGES:
        inp = moe_inputs(torch, GG, MR, gen, T=T, E=E, D=D, H=H, cap=cap,
                         hot=hot)
        held = (inp["row_id"] < T).sum(1)
        res = moe_errors(torch, GG, inp["x"], inp["row_id"], inp["gate_w"],
                         inp["wi"], inp["wg"], inp["wo"], inp["g"], act)
        if hot and not (held[0] == T and not held[1:].any()):
            res["failures"].append(f"hot: expert loads {held.tolist()}")
        out.append({"case": [T, E, D, H, cap, act, hot],
                    "cpad": inp["cpad"], **res})
        del inp
    return out


def phase_moe_kernels(torch, MR, GG) -> dict:
    """The routing kernel and the three grouped-GEMM kernels at the
    Qwen2-MoE training shapes (T 8192, E 16, D 1024, H 704, cpad 1280),
    after ``MOE_EDGES`` (each with the checks below but the times),
    bf16 (fp32 logits): each against its plain version (routing by
    ROUTE_*; the grouped kernels by the flash rule, each row within
    2**-7 of its largest magnitude + 1e-3 and 4e-3 in relative Frobenius
    norm) and launched twice for a bitwise repeat; then the time of each
    (CUDA events and profiler device time), of its plain version, its
    bound from this run's occupied slots, and as a yardstick only the
    ``torch.bmm`` calls of its products over packed [16, 1280, *]
    buffers, without the gathers (none for routing). For the grouped
    kernels also the device time of each pass (and memset) by kernel
    name, from the profiler (``device_ms_by_kernel``)."""
    edges = moe_edge_errors(
        torch, GG, MR, torch.Generator(device="cuda").manual_seed(SEED + 6))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    inp = moe_inputs(torch, GG, MR, gen)
    T, E = inp["logits"].shape
    D, H = inp["wi"].shape[1:]
    cpad, n = inp["cpad"], inp["occupied"]
    route = routing_errors(torch, MR, inp["logits"], inp["u"])
    args = (inp["x"], inp["row_id"], inp["gate_w"], inp["wi"], inp["wg"],
            inp["wo"])
    grouped = moe_errors(torch, GG, *args, inp["g"])
    failures = route.pop("failures") + grouped.pop("failures")
    failures += [f"{e['case']}: {f}" for e in edges for f in e["failures"]]
    _emit("moe_kernel_check", {"routing": route, "grouped": grouped,
                               "edges": edges, "occupied_slots": n,
                               "slots": E * cpad})
    if failures:
        raise AssertionError(f"MoE kernels differ from their plain "
                             f"versions: {failures}")
    # yardsticks: packed operands, no gathers
    xp = torch.randn((E, cpad, D), device="cuda").bfloat16()
    hp = torch.randn((E, cpad, H), device="cuda").bfloat16()
    wi, wg, wo = inp["wi"], inp["wg"], inp["wo"]
    wit, wgt, wot = (w.transpose(1, 2) for w in (wi, wg, wo))
    xpt, hpt = xp.transpose(1, 2), hp.transpose(1, 2)

    def lib_fwd():
        return torch.bmm(xp, wi), torch.bmm(xp, wg), torch.bmm(hp, wo)

    def lib_dx():
        return (torch.bmm(xp, wi), torch.bmm(xp, wg), torch.bmm(xp, wot),
                torch.bmm(hp, wo), torch.bmm(hp, wit), torch.bmm(hp, wgt))

    def lib_dw():
        return torch.bmm(xpt, hp), torch.bmm(xpt, hp), torch.bmm(hpt, xp)

    _, _, inter = GG.moe_dx_cuda(*args, inp["g"], "silu")
    route_args = [(inp["logits"], inp["u"], True)]
    fwd_args, dx_args = [args + ("silu",)], [args + (inp["g"], "silu")]
    dw_args = [(inp["x"], inp["row_id"], inp["gate_w"], inp["g"], inter)]
    maps = E * cpad * 8
    xb, wb = T * D * 2, 3 * E * D * H * 2
    work = {   # name: (flops, bytes) for this run's occupied slots
        "moe_routing": (0.0, T * E * 4 + T * 4 + 7 * T * 4 + 2 * E * 4),
        "moe_fwd": (3 * 2.0 * n * D * H, xb + wb + maps + T * D * 4),
        "moe_dx": (6 * 2.0 * n * D * H,
                   2 * xb + wb + maps + T * D * 4 + E * cpad * 4
                   + 3 * E * cpad * H * 2),
        "moe_dw": (3 * 2.0 * n * D * H,
                   2 * xb + maps + 3 * E * cpad * H * 2 + wb)}
    fns = {
        "moe_routing": ({"kernel": MR.moe_routing_cuda,
                         "plain": MR.routing_plain}, route_args),
        "moe_fwd": ({"kernel": GG.moe_fwd_cuda, "plain": GG.moe_fwd_plain,
                     "library": lambda *a: lib_fwd()}, fwd_args),
        "moe_dx": ({"kernel": GG.moe_dx_cuda, "plain": GG.moe_dx_plain,
                    "library": lambda *a: lib_dx()}, dx_args),
        "moe_dw": ({"kernel": GG.moe_dw_cuda, "plain": GG.moe_dw_plain,
                    "library": lambda *a: lib_dw()}, dw_args)}
    err_of = {"moe_fwd": ("out",), "moe_dx": ("dx", "dgw", "h"),
              "moe_dw": ("dw_in", "dw_gate", "dw_out")}
    rows = {}
    for name, (fn, sets) in fns.items():
        flops, nbytes = work[name]
        bound, bound_by = _bound(flops, nbytes)
        t = _timings(torch, fn, sets)
        if name == "moe_routing":
            err = {"max_abs_err": route["max_abs_err"],
                   "tolerance": f"decisions equal but where the margin < "
                                f"{ROUTE_MARGIN}; positions exact; g1, g2 "
                                f"{ROUTE_ATOL} absolute; me_sum "
                                f"{ROUTE_ME_RTOL} relative",
                   "library_ms": None, "library_device_ms": None}
        else:
            e = grouped["errors"]
            err = {"max_abs_err": max(e[o]["max_abs"] for o in err_of[name]),
                   "max_row_ratio": max(e[o]["row"] for o in err_of[name]),
                   "max_rel_fro": max(e[o]["fro"] for o in err_of[name]),
                   "tolerance": "each row within 2**-7 of its largest "
                                "magnitude + 1e-3; relative Frobenius "
                                "<= 4e-3; bitwise repeatable"}
        rows[name] = {"shape": {"T": T, "E": E, "D": D, "H": H, "cpad": cpad,
                                "occupied_slots": n, "dtype": "bfloat16"},
                      **err, **t, "flops": flops, "bytes": nbytes,
                      "bound_ms": bound, "bound_by": bound_by}
        if name != "moe_routing":
            prof = _profile_steps(torch, lambda: fn["kernel"](*sets[0]), 20,
                                  top=None)
            rows[name]["device_ms_by_kernel"] = {
                _short_kernel_name(k_): ms
                for k_, ms in prof["all_kernels_ms"]}
        _emit("kernel_vs_plain", {"name": name, **rows[name]})
    return rows


# The fp32 slice: the expert width that the fused gates admit in fp32
# (moe_fp32_config), the shapes of its kernel check (moe_fp32_kernels),
# and the smaller shape at which both FFN kinds are checked.
MOE_FP32_H = 512
MOE_FP32_SMALL = {"T": 2048, "E": 8, "D": 256, "H": 96}
# the long-K case: one expert holding all T tokens (capacity T, the others
# empty), so that dW sums over 8192 slots (256 chunks of 32, each into a
# fresh accumulator) where the slice's fullest expert has 1280
MOE_FP32_LONG = {"T": 8192, "E": 4, "D": 1024, "H": 128}
# the long-H case: the forward's y = h W_out and dX's dh1 W_in^T sum over
# K = H 8192 (256 chunks of 32, each into a fresh accumulator) where the
# slice's H gives 16
MOE_FP32_LONG_H = {"T": 2048, "E": 4, "D": 256, "H": 8192}
MOE_FP32_KERNELS = ("moe_routing", "moe_fwd_fp32", "moe_dx_fp32",
                    "moe_dw_fp32")


def moe_fp32_errors(torch, GG, x, row_id, gate_w, wi, wg, wo, g,
                    act="silu") -> dict:
    """The fp32 grouped-GEMM kernels and their plain fp32 versions, each
    against the plain versions run in fp64 on the same inputs: forward
    ``out``; dX's ``dx`` and ``dgw`` (occupied slots); dW's three
    outputs from the kernel's own dX intermediates (in fp64 for the
    reference), so each kernel is held alone. The flash fp32 rule per
    output (``_rel_errors``): worst row and relative Frobenius error at
    most ``FP32_RATIO`` x the plain fp32 version's plus ``FP32_ROW_FLOOR``
    / ``FP32_FRO_FLOOR``. Each kernel is launched twice and must repeat
    bitwise. ``wg`` None runs the ungated FFN."""
    args = (x, row_id, gate_w, wi, wg, wo)
    out = GG.moe_fwd_cuda(*args, act)
    out2 = GG.moe_fwd_cuda(*args, act)
    dx, dgw, inter = GG.moe_dx_cuda(*args, g, act)
    dx2, dgw2, _ = GG.moe_dx_cuda(*args, g, act)
    dws = GG.moe_dw_cuda(x, row_id, gate_w, g, inter)
    dws2 = GG.moe_dw_cuda(x, row_id, gate_w, g, inter)
    torch.cuda.synchronize()
    occ = (row_id < x.shape[0]).float()
    repeat = {"fwd": torch.equal(out, out2),
              "dx": torch.equal(dx, dx2) and torch.equal(dgw * occ,
                                                         dgw2 * occ),
              "dw": all(a is None or torch.equal(a, b)
                        for a, b in zip(dws, dws2))}
    failures = [f"{k}: a second launch differs" for k, v in repeat.items()
                if not v]
    x64, g64 = x.double(), g.double()
    a64 = (x64, row_id, gate_w, wi.double(),
           None if wg is None else wg.double(), wo.double())
    got = {"out": out, "dx": dx, "dgw": dgw * occ}
    ref = {"out": GG.moe_fwd_plain(*a64, act)}
    plain = {"out": GG.moe_fwd_plain(*args, act)}
    rdx, rdgw, _ = GG.moe_dx_plain(*a64, g64, act)
    pdx, pdgw, _ = GG.moe_dx_plain(*args, g, act)
    ref.update(dx=rdx, dgw=rdgw * occ)
    plain.update(dx=pdx, dgw=pdgw * occ)
    inter64 = tuple(None if t is None else t.double() for t in inter)
    for name, k_, r_, p_ in zip(
            ("dw_in", "dw_gate", "dw_out"), dws,
            GG.moe_dw_plain(x64, row_id, gate_w, g64, inter64),
            GG.moe_dw_plain(x, row_id, gate_w, g, inter)):
        if k_ is not None:
            got[name], ref[name], plain[name] = k_, r_, p_
    errs = {}
    for name in got:
        ke = _rel_errors(torch, got[name], ref[name])
        pe = _rel_errors(torch, plain[name], ref[name])
        errs[name] = {"kernel": ke, "plain": pe}
        for m, floor in (("row", FP32_ROW_FLOOR), ("fro", FP32_FRO_FLOOR)):
            limit = FP32_RATIO * pe[m] + floor
            if not ke[m] <= limit:
                failures.append(f"{name}: {m} error {ke[m]:.3g} > "
                                f"{FP32_RATIO} x plain {pe[m]:.3g} + "
                                f"{floor:.3g}")
    return {"errors": errs, "bitwise_repeat": repeat, "failures": failures}


def moe_fp32_long_errors(torch, GG, MR, gen) -> dict:
    """``moe_fp32_errors`` (gated silu) at ``MOE_FP32_LONG``, expert 0
    holding every token (``moe_inputs(hot=True)``, capacity T)."""
    L = MOE_FP32_LONG
    inp = moe_inputs(torch, GG, MR, gen, T=L["T"], E=L["E"], D=L["D"],
                     H=L["H"], dtype="float32", cap=L["T"], hot=True)
    c = moe_fp32_errors(torch, GG, inp["x"], inp["row_id"], inp["gate_w"],
                        inp["wi"], inp["wg"], inp["wo"], inp["g"])
    held = (inp["row_id"] < L["T"]).sum(1).tolist()
    if held != [L["T"]] + [0] * (L["E"] - 1):
        c["failures"].append(f"expected one expert to hold every token, "
                             f"got {held}")
    return c


def moe_fp32_long_h_errors(torch, GG, MR, gen) -> dict:
    """``moe_fp32_errors`` (gated silu) at ``MOE_FP32_LONG_H``."""
    L = MOE_FP32_LONG_H
    inp = moe_inputs(torch, GG, MR, gen, T=L["T"], E=L["E"], D=L["D"],
                     H=L["H"], dtype="float32")
    return moe_fp32_errors(torch, GG, inp["x"], inp["row_id"],
                           inp["gate_w"], inp["wi"], inp["wg"], inp["wo"],
                           inp["g"])


def phase_moe_fp32_kernels(torch, MR, GG) -> dict:
    """The fp32 mode of the grouped-GEMM forward, dX and dW (3xTF32) at the
    fp32 slice's shapes (T 8192, E 16, D 1024, H ``MOE_FP32_H``, cpad
    1280, gated silu, ``moe_inputs``' skewed logits, so that some experts
    fill) and both FFN kinds (gated silu, ungated relu) at
    ``MOE_FP32_SMALL``, the long-K case ``MOE_FP32_LONG`` and the long-H
    case ``MOE_FP32_LONG_H``: each held
    by ``moe_fp32_errors`` against fp64 and launched twice for a bitwise
    repeat. Then, at the slice's shapes, the
    time of each (CUDA events and profiler device time), of its plain
    fp32 version, its bound (its products on this run's occupied slots
    at ``FP32_ACCURATE_FLOPS``, or its bytes), and as a yardstick only
    the ``torch.bmm`` fp32 calls of its products over packed [16, 1280,
    *] buffers, TF32 off."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    checks, failures = {}, []
    small = MOE_FP32_SMALL
    for act in ("silu", "relu"):
        inp = moe_inputs(torch, GG, MR, gen, T=small["T"], E=small["E"],
                         D=small["D"], H=small["H"], dtype="float32")
        c = moe_fp32_errors(
            torch, GG, inp["x"], inp["row_id"], inp["gate_w"], inp["wi"],
            inp["wg"] if act == "silu" else None, inp["wo"], inp["g"], act)
        checks[f"small_{act}"] = c
        failures += [f"small_{act} {f}" for f in c.pop("failures")]
    inp = moe_inputs(torch, GG, MR, gen, H=MOE_FP32_H, dtype="float32")
    T, E = inp["logits"].shape
    D, H = inp["wi"].shape[1:]
    cpad, n = inp["cpad"], inp["occupied"]
    args = (inp["x"], inp["row_id"], inp["gate_w"], inp["wi"], inp["wg"],
            inp["wo"])
    c = moe_fp32_errors(torch, GG, *args, inp["g"])
    checks["slice"] = c
    failures += [f"slice {f}" for f in c.pop("failures")]
    c = moe_fp32_long_errors(torch, GG, MR, gen)
    checks["long_k"] = c
    failures += [f"long_k {f}" for f in c.pop("failures")]
    c = moe_fp32_long_h_errors(torch, GG, MR, gen)
    checks["long_h"] = c
    failures += [f"long_h {f}" for f in c.pop("failures")]
    _emit("moe_fp32_kernel_check", {"checks": checks, "occupied_slots": n,
                                    "slots": E * cpad,
                                    "small_shape": small})
    if failures:
        raise AssertionError(f"fp32 MoE kernels beyond tolerance: "
                             f"{failures}")
    xp = torch.randn((E, cpad, D), device="cuda")
    hp = torch.randn((E, cpad, H), device="cuda")
    wi, wg, wo = inp["wi"], inp["wg"], inp["wo"]
    wit, wgt, wot = (w.transpose(1, 2) for w in (wi, wg, wo))
    xpt, hpt = xp.transpose(1, 2), hp.transpose(1, 2)

    def lib_fwd():
        return torch.bmm(xp, wi), torch.bmm(xp, wg), torch.bmm(hp, wo)

    def lib_dx():
        return (torch.bmm(xp, wi), torch.bmm(xp, wg), torch.bmm(xp, wot),
                torch.bmm(hp, wo), torch.bmm(hp, wit), torch.bmm(hp, wgt))

    def lib_dw():
        return torch.bmm(xpt, hp), torch.bmm(xpt, hp), torch.bmm(hpt, xp)

    _, _, inter = GG.moe_dx_cuda(*args, inp["g"], "silu")
    fwd_args, dx_args = [args + ("silu",)], [args + (inp["g"], "silu")]
    dw_args = [(inp["x"], inp["row_id"], inp["gate_w"], inp["g"], inter)]
    maps = E * cpad * 8
    xb, wb, ib = T * D * 4, 3 * E * D * H * 4, E * cpad * H * 4
    work = {   # name: (flops, bytes) for this run's occupied slots
        "moe_fwd_fp32": (3 * 2.0 * n * D * H, xb + wb + maps + T * D * 4),
        "moe_dx_fp32": (6 * 2.0 * n * D * H,
                        2 * xb + wb + maps + T * D * 4 + E * cpad * 4
                        + 3 * ib),
        "moe_dw_fp32": (3 * 2.0 * n * D * H, 2 * xb + maps + 3 * ib + wb)}
    fns = {
        "moe_fwd_fp32": ({"kernel": GG.moe_fwd_cuda,
                          "plain": GG.moe_fwd_plain,
                          "library": lambda *a: lib_fwd()}, fwd_args),
        "moe_dx_fp32": ({"kernel": GG.moe_dx_cuda, "plain": GG.moe_dx_plain,
                         "library": lambda *a: lib_dx()}, dx_args),
        "moe_dw_fp32": ({"kernel": GG.moe_dw_cuda, "plain": GG.moe_dw_plain,
                         "library": lambda *a: lib_dw()}, dw_args)}
    err_of = {"moe_fwd_fp32": ("out",), "moe_dx_fp32": ("dx", "dgw"),
              "moe_dw_fp32": ("dw_in", "dw_gate", "dw_out")}
    e = checks["slice"]["errors"]
    rows = {}
    for name, (fn, sets) in fns.items():
        flops, nbytes = work[name]
        bound, bound_by = _bound(flops, nbytes, FP32_ACCURATE_FLOPS)
        t = _timings(torch, fn, sets)
        rows[name] = {
            "shape": {"T": T, "E": E, "D": D, "H": H, "cpad": cpad,
                      "occupied_slots": n, "dtype": "float32"},
            "max_abs_err": max(e[o]["kernel"]["max_abs"]
                               for o in err_of[name]),
            "errors_at_shape": {o: e[o] for o in err_of[name]},
            "tolerance": FP32_TOLERANCE.split("; lse")[0] + "; bitwise "
                         "repeatable", **t, "flops": flops, "bytes": nbytes,
            "bound_ms": bound, "bound_by": bound_by,
            "bound_peak_flops": FP32_ACCURATE_FLOPS}
        _emit("kernel_vs_plain", {"name": name, **rows[name]})
    return rows


def _moe_active_params(cfg, n_params: int) -> int:
    """bench.py:464-466: all parameters but the routed experts a token
    does not use."""
    return n_params - cfg.num_hidden_layers * (
        cfg.num_experts - cfg.num_experts_per_tok) * (
        3 * cfg.hidden_size * cfg.moe_intermediate_size)


def _count_drops(port_moe):
    """Wrap ``moe_fused_compute`` to keep each call's dropped-copy count
    (a device tensor, read after the step); returns the list and an undo
    function."""
    calls, orig = [], port_moe.moe_fused_compute

    def counting(x, idx, w, pos, keep, *rest):
        calls.append((~keep).sum())
        return orig(x, idx, w, pos, keep, *rest)
    port_moe.moe_fused_compute = counting
    return calls, lambda: setattr(port_moe, "moe_fused_compute", orig)


def phase_train_moe(torch, K, model, TrainStep, AdamW, batch, smi,
                    tag="train_moe", cut=None) -> tuple:
    """10 TrainSteps of the ``qwen2_moe_fused`` configuration on one fixed
    batch (labels = inputs, as bench.py:488): step wall times, the median
    of steps 3-10, tokens/s, ``mfu_active`` (``6 * n_active * tokens/s``
    over the 989 TFLOP/s bf16 peak, bench.py:496), peak memory, every
    loss and aux loss, the dropped copies per layer in each step, and the
    launch counters of this phase alone (one routing, forward, dX and dW
    launch per layer and step, in the model's mode: an fp32 model, as
    ``moe_fp32_config``, takes the ``_fp32`` modes of the flash and
    grouped-GEMM kernels and none of the bf16 ones, and reports
    ``mfu_active`` over the 67 TFLOP/s fp32 peak too). ``tag`` names the
    phase's line; ``cut`` says how the configuration was cut."""
    from paddle_tpu_torch.distributed import moe as port_moe
    cfg = model.config
    L = cfg.num_hidden_layers
    opt = AdamW(learning_rate=TRAIN_LR, parameters=model)
    step = TrainStep(model, opt, lambda logits, y: model.loss(logits, y))
    drops, undo = _count_drops(port_moe)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    losses, auxes, times, dropped = [], [], [], []
    try:
        for _ in range(MOE_STEPS):
            drops.clear()
            t0 = time.perf_counter()
            loss = step(batch, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(loss.item())
            auxes.append(model.aux_loss().item())
            dropped.append([int(d) for d in drops])
    finally:
        undo()
    launches = K.launch_counts()
    n_params = model.num_params()
    n_active = _moe_active_params(cfg, n_params)
    step_s = statistics.median(times[2:])
    tokens = MOE_BATCH * MOE_SEQ
    fp32 = cfg.dtype == "float32"
    out = {"config": cfg.__dict__, "params": n_params,
           "params_active": n_active, "batch": MOE_BATCH, "seq": MOE_SEQ,
           "lr": TRAIN_LR, "step_ms": [t * 1e3 for t in times],
           "median_step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
           "mfu_active": 6.0 * n_active * tokens / step_s
           / BF16_TENSOR_FLOPS,
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "losses": losses, "aux_losses": auxes,
           "dropped_copies_per_layer": dropped, "launches": launches,
           "card": smi}
    if fp32:
        out["mfu_active_fp32_peak"] = (6.0 * n_active * tokens / step_s
                                       / FP32_FLOPS)
    if cut is not None:
        out["cut"] = cut
    _emit(tag, out)
    if not all(math.isfinite(x) for x in losses + auxes):
        raise AssertionError(f"non-finite training loss: {losses} {auxes}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall on a fixed batch: "
                             f"{losses}")
    n, sfx = L * MOE_STEPS, "_fp32" if fp32 else ""
    want = _counts(K, rms_norm=(2 * L + 1) * MOE_STEPS, moe_routing=n,
                   **{f"{k}{sfx}": n for k in FLASH_KERNELS
                      + ("moe_fwd", "moe_dx", "moe_dw")})
    if launches != want or any(len(d) != L for d in dropped):
        raise AssertionError(f"launch counters {launches} != expected "
                             f"{want} over {MOE_STEPS} steps (fused "
                             f"dispatch calls per step: "
                             f"{[len(d) for d in dropped]})")
    return out, opt


# MoE train parity limits (see phase_train_moe_parity)
MOE_PARITY = (2e-3, 0.25, 3e-4)
MOE_PROBE_LIMITS = (0.2, 0.2)     # routed output, its input gradient


def moe_probes(model) -> list:
    """Each sparse layer's ``MoELayer``: (name, module)."""
    return [(f"layers.{i}.mlp.moe", layer.mlp.moe)
            for i, layer in enumerate(model.layers) if layer.is_sparse]


def phase_train_moe_parity(torch, K, model, opt, TrainStep, batch) -> dict:
    """``train_parity_run`` on the MoE model, the routers' generator
    reseeded before each run. Limits (``MOE_PARITY``): per-step |loss
    difference| 2e-3, every first-step gradient 0.25 in relative L2, the
    fp32 master weights 3e-4 apart after step 3. The correct kernels
    (control, NVIDIA H100 80GB HBM3, 700 W) gave 2.0e-4, 0.082
    (``layers.7.mlp.moe.experts.w_out``) and 1.28e-4: wider than the
    Llama step's because the two runs' bf16 activations differ by an ulp
    here and there, which flips the routing of tokens near a tie; a
    flipped token moves its gradient to another expert and shifts the
    FCFS slots after it, and at this capacity (15-27% of the copies
    dropped) a shifted slot changes which copies are dropped. Adam turns
    a gradient that changes sign into a 2 lr step, so the master weights
    can part by up to 6e-4 in 3 steps wherever that happens.

    Two more limits (``MOE_PROBE_LIMITS``) watch each ``MoELayer``
    itself in the first step: its output and the gradient at its input,
    0.3 in relative L2. At init the routed experts add ~1e-3 of the
    residual stream (the JAX package's XavierNormal over a 3-D weight:
    std ~0.0017), so a wrong routed output or dX moves the loss and the
    weight gradients by less than the noise above; only the layer's own
    tensors show it. ``chip_mutants.py`` shows which MoE kernel faults
    these limits catch."""
    out = train_parity_run(
        torch, K, model, opt, TrainStep, *causal_lm_args(model, batch),
        kernels=FLASH_KERNELS + MOE_KERNELS, limits=MOE_PARITY,
        reseed=lambda: model.generator.manual_seed(SEED + 6),
        probes=moe_probes(model), probe_limits=MOE_PROBE_LIMITS)
    _emit("train_moe_parity", {k: v for k, v in out.items()
                               if k != "grad_rel_l2"})
    if out["failures"]:
        raise AssertionError(f"MoE train parity beyond tolerance: "
                             f"{out['failures']}")
    return out


# The fp32 slice's cut, printed on its line (see moe_fp32_config).
MOE_FP32_CUT = (f"moe_intermediate_size {MOE_FP32_H} of bench.py's 704: "
                f"the fused gate of both packages rejects fp32 at 704 "
                f"(VMEM term, 20 D H + 1 MiB <= 14 MiB at D 1024, so H <= "
                f"665) and admits it at {MOE_FP32_H}; depth and every "
                f"other width as bench.py")


def _record_routing(torch, port_moe):
    """Wrap ``_top2_parts`` for a ``train_parity_run`` whose plain run
    comes first (``plain_first``), to keep each call's logits, uniforms
    and chosen experts. Returns the list, a function to call before each
    run (at its second call it marks where the kernel run starts), and an
    undo function. A kernel-run row that decides otherwise than the plain
    run's same call at a near tie (``_near_ties``) is routed on the plain
    run's logits (their value; its gradient flows through the kernel
    run's own), so the two runs take one route, which the gradient limits
    can hold; the plain run is left as it is. The list keeps each call's
    own logits and decisions, so that ``routing_agreement`` judges and
    counts every such row."""
    calls, orig, n_plain = [], port_moe._top2_parts, []

    def mark():
        if calls and not n_plain:
            n_plain.append(len(calls))

    def recording(logits, capacity, **kw):
        res = orig(logits, capacity, **kw)
        own = (logits.detach().float().clone(), kw["u"].clone(),
               res[0].clone(), res[1].clone())
        i = len(calls) - n_plain[0] if n_plain else None
        calls.append(own)
        if i is not None and i < n_plain[0]:
            tie = _near_ties(torch, own, calls[i])[1]
            if bool(tie.any()):
                alike = (calls[i][0].to(logits.dtype)
                         + (logits - logits.detach()))
                res = orig(torch.where(tie[:, None], alike, logits),
                           capacity, **kw)
        return res
    port_moe._top2_parts = recording
    return calls, mark, lambda: setattr(port_moe, "_top2_parts", orig)


def _keep2(torch, logits, u):
    """The random second-expert keep of the plain chain (``u < 2 g2 /
    (g1 + g2)``) from a run's own logits."""
    p = torch.softmax(logits, dim=-1).topk(2, dim=-1).values
    return u < 2.0 * p[:, 1] / torch.clamp(p[:, 0] + p[:, 1], min=1e-9)


def _near_ties(torch, kernel_call, plain_call):
    """The rows of one routing call whose decisions (either expert, the
    keep of the second) differ between the kernel run and the plain run,
    and those of them whose plain-run margin (``_route_margin``) is below
    ``ROUTE_MARGIN``."""
    (lk, uk, g1k, g2k), (lp, up, g1p, g2p) = kernel_call, plain_call
    differ = ((g1k != g1p) | (g2k != g2p)
              | (_keep2(torch, lk, uk) != _keep2(torch, lp, up)))
    return differ, differ & (_route_margin(torch, lp, up) < ROUTE_MARGIN)


# At most this many rows of a kernel run may be routed on the plain run's
# logits (``_record_routing``): the correct kernels route 1 of the fp32
# MoE parity's 196,608 (NVIDIA H100 80GB HBM3, 700 W).
ROUTED_ALIKE_MAX = 16


def routing_agreement(torch, calls) -> dict:
    """Routing decisions (both experts and the random keep of the second)
    of the plain run (first half of ``calls``) against the kernel run's
    (second half), call by call (a layer in a step): a decision may
    differ only where the plain run's margin (``_route_margin``) is below
    ``ROUTE_MARGIN``, and at most ``ROUTED_ALIKE_MAX`` rows so (those
    ``_record_routing`` routed alike). Returns the count of rows that
    differ, of those routed alike, the largest margin among them, and
    ``failures``."""
    n = len(calls) // 2
    differing, alike, worst, failures = 0, 0, 0.0, []
    for i, (pc, kc) in enumerate(zip(calls[:n], calls[n:])):
        if not torch.equal(pc[1], kc[1]):
            failures.append(f"routing call {i}: the uniforms differ")
        differ, tie = _near_ties(torch, kc, pc)
        nd = int(differ.sum())
        if nd:
            differing += nd
            alike += int(tie.sum())
            worst = max(worst, _route_margin(torch, pc[0], pc[1])[differ]
                        .max().item())
    if differing and not worst < ROUTE_MARGIN:
        failures.append(f"routing: {differing} rows decide otherwise, one "
                        f"with margin {worst} >= {ROUTE_MARGIN}")
    if alike > ROUTED_ALIKE_MAX:
        failures.append(f"routing: {alike} rows routed alike > "
                        f"{ROUTED_ALIKE_MAX}")
    if len(calls) % 2 or not n:
        failures.append(f"routing: {len(calls)} calls recorded")
    return {"calls_per_run": n, "rows_deciding_otherwise": differing,
            "rows_routed_alike": alike, "their_largest_margin": worst,
            "failures": failures}


def phase_train_moe_fp32_parity(torch, K, model, opt, TrainStep,
                                batch) -> dict:
    """``train_parity_run`` on the fp32 MoE model (``moe_fp32_config``)
    at ``FP32_PARITY``, the routers' generator reseeded before each run:
    the fp32 flash and grouped-GEMM kernels and the routing kernel must
    launch. Each ``MoELayer``'s first-step output and input gradient are
    held to the gradient limit too (both runs fp32: the routed experts add
    ~1e-3 of the residual stream, so only the layer's own tensors show a
    fault in its output or dX). The routing-margin rule
    (``routing_agreement``) holds every layer's decisions in all three
    steps: they may differ only where the margin is below
    ``ROUTE_MARGIN``. Such a near tie flips either way on rounding (a row
    at margin 1.5e-7 took one expert under one commit's kernels and the
    other under the next's, from states 1e-7 apart), and one token routed
    otherwise moves its layer's router gradient by ~0.5%: so the plain
    run comes first, and the kernel run routes those rows on the plain
    run's logits (``_record_routing``; at most ``ROUTED_ALIKE_MAX``, their
    count is ``routing.rows_routed_alike``), and the gradient limits hold
    the two runs on one route."""
    from paddle_tpu_torch.distributed import moe as port_moe
    calls, mark, undo = _record_routing(torch, port_moe)

    def reseed():
        mark()
        model.generator.manual_seed(SEED + 6)
    try:
        out = train_parity_run(
            torch, K, model, opt, TrainStep, *causal_lm_args(model, batch),
            kernels=FP32_KERNELS + MOE_FP32_KERNELS, limits=FP32_PARITY,
            reseed=reseed, probes=moe_probes(model),
            probe_limits=(FP32_PARITY[1], FP32_PARITY[1]), plain_first=True)
    finally:
        undo()
    route = routing_agreement(torch, calls)
    out["failures"] += route.pop("failures")
    out["routing"] = route
    _emit("train_moe_fp32_parity", {k: v for k, v in out.items()
                                    if k != "grad_rel_l2"})
    if out["failures"]:
        raise AssertionError(f"fp32 MoE train parity beyond tolerance: "
                             f"{out['failures']}")
    return out


_MOE_CATEGORIES = (
    ("moe_expert", ("expert_h_kernel", "fwd_out_kernel", "dx_out_kernel",
                    "dgw_reduce_kernel", "dw_kernel", "dx_h_wgmma_kernel",
                    "dx_out_wgmma_kernel", "dw_wgmma_kernel",
                    "dx_h_tf32_kernel", "dx_out_tf32_kernel",
                    "dw_tf32_kernel", "split_hilo_kernel")),
    ("moe_routing", ("routing_tiles_kernel", "routing_kernel")),
) + _CATEGORIES


def flash_bwd_kernels(names) -> list:
    """The flash backward kernels among a profile's kernel names, each cut
    to its template (the bf16 wgmma ``dq_wgmma_kernel<D, HAS_BIAS, DROP>``
    and ``dkv_wgmma_kernel<...>``, the fp32 TF32 wgmma
    ``dq_tf32_kernel<HAS_BIAS, DROP>`` and ``dkv_tf32_kernel<...>``, the
    mma.sync
    ``flash_bwd_*_kernel<T, ...>``)."""
    return sorted({_short_kernel_name(n) for n in names
                   if "dq_wgmma_kernel<" in n or "dkv_wgmma_kernel<" in n
                   or "dq_tf32_kernel<" in n or "dkv_tf32_kernel<" in n
                   or "flash_bwd_" in n})


def flash_fwd_kernels(names) -> list:
    """The flash forward kernels among a profile's kernel names, each cut
    to its template (the bf16 wgmma ``fwd_wgmma_kernel<D, HAS_BIAS,
    DROP>``, the fp32 TF32 wgmma ``fwd_tf32_kernel<HAS_BIAS, DROP>``, the
    mma.sync ``flash_fwd_kernel<T, ...>``)."""
    return sorted({_short_kernel_name(n) for n in names
                   if "fwd_wgmma_kernel<" in n or "fwd_tf32_kernel<" in n
                   or "flash_fwd_kernel<" in n})


_GROUPED = _MOE_CATEGORIES[0][1]
_ROUTING = _MOE_CATEGORIES[1][1]


def grouped_kernels(names) -> list:
    """The grouped-GEMM kernels among a profile's kernel names, each cut
    to its template."""
    return sorted({_short_kernel_name(n) for n in names
                   if any(k_ in n for k_ in _GROUPED)})


def routing_kernels(names) -> list:
    """The routing kernels among a profile's kernel names."""
    return sorted({_short_kernel_name(n) for n in names
                   if any(k_ in n for k_ in _ROUTING)})


def _grouped_pass(short: str) -> str | None:
    """The pass that a grouped kernel (a short name) belongs to: "fwd",
    "dx" or "dw"; None for a split, which serves the pass after it."""
    if short.startswith("split_hilo_kernel"):
        return None
    if short.startswith(("dx_h_", "dx_out_")):
        return "fwd" if short.endswith(", true>") else "dx"
    if short.startswith("dgw_reduce_kernel"):
        return "dx"
    if short.startswith("dw_"):
        return "dw"
    return "fwd" if short.startswith(("expert_h_kernel", "fwd_out_kernel")) \
        else None


def grouped_passes(sequence) -> dict:
    """The grouped kernels of a profile's kernel names in launch order
    (``sequence``), by pass: each kernel's own, and each split launch
    (``split_hilo_kernel``, which the fp32 forward and dW both launch as
    ``<false>``) the pass of the next grouped kernel after it, the one
    that reads what it wrote."""
    out: dict = {}
    pending: set = set()
    for n in sequence:
        if not any(k_ in n for k_ in _GROUPED):
            continue
        short = _short_kernel_name(n)
        kind = _grouped_pass(short)
        if kind is None:
            pending.add(short)
            continue
        out.setdefault(kind, set()).update(pending | {short})
        pending = set()
    return {k: sorted(v) for k, v in out.items()}


# the bf16 grouped forward: pass 1 (h) of either FFN kind, and pass 2
GROUPED_FWD = ("dx_h_wgmma_kernel<true, true>",
               "dx_h_wgmma_kernel<false, true>",
               "dx_out_wgmma_kernel<false, true>")


def check_wgmma_forward(tag, prof, mode, grouped=False) -> None:
    """A profiled bf16 step's flash forward: exactly the wgmma kernel of
    ``mode`` (``"<64, true, false>"``: D, HAS_BIAS, DROP), so no bf16
    mma.sync ``flash_fwd_kernel``. With ``grouped``, its grouped forward: the
    wgmma pass 1 and pass 2 (``GROUPED_FWD``), and no first-design
    ``expert_h_kernel`` or ``fwd_out_kernel``."""
    want = [f"flash_wg::fwd_wgmma_kernel{mode}"]
    if prof["flash_fwd_kernels"] != want:
        raise AssertionError(f"{tag}: the flash forward ran "
                             f"{prof['flash_fwd_kernels']}, not {want}")
    if grouped:
        ran = prof["grouped_kernels"]
        fwd = [k_ for k_ in ran if k_ in GROUPED_FWD]
        old = [k_ for k_ in ran if k_.startswith(("expert_h_kernel",
                                                  "fwd_out_kernel"))]
        if len(fwd) != 2 or "dx_out_wgmma_kernel<false, true>" not in fwd \
                or old:
            raise AssertionError(f"{tag}: the grouped forward ran {ran}")


def check_wgmma_backward(tag, kernels, mode) -> None:
    """A profiled bf16 step's flash backward: exactly the wgmma dQ and
    dK/dV kernels of ``mode`` (``"<64, true, false>"``: D, HAS_BIAS,
    DROP), so no bf16 mma.sync ``flash_bwd_*_kernel``."""
    want = [f"flash_wg::{k}_wgmma_kernel{mode}" for k in ("dkv", "dq")]
    if kernels != want:
        raise AssertionError(f"{tag}: the flash backward ran {kernels}, "
                             f"not {want}")


def check_fp32_backward(tag, kernels, drop, bias=False) -> None:
    """A profiled fp32 step's flash backward (d 64): exactly the TF32
    wgmma dQ and dK/dV kernels of its mode (``bias``, ``drop``: the
    ``<HAS_BIAS, DROP>`` instantiations), so no fp32 mma.sync
    ``flash_bwd_*_kernel``."""
    mode = f"<{str(bias).lower()}, {str(drop).lower()}>"
    want = [f"flash_tf32::{k}_tf32_kernel{mode}" for k in ("dkv", "dq")]
    if kernels != want:
        raise AssertionError(f"{tag}: the fp32 flash backward ran {kernels}, "
                             f"not {want}")


def check_fp32_forward(tag, prof, bias, drop) -> None:
    """A profiled fp32 step's flash forward (d 64): exactly the TF32 wgmma
    kernel of its mode (``bias``, ``drop``: the ``<HAS_BIAS, DROP>``
    instantiation), so no fp32 mma.sync ``flash_fwd_kernel``."""
    mode = f"<{str(bias).lower()}, {str(drop).lower()}>"
    want = [f"flash_tf32::fwd_tf32_kernel{mode}"]
    if prof["flash_fwd_kernels"] != want:
        raise AssertionError(f"{tag}: the fp32 flash forward ran "
                             f"{prof['flash_fwd_kernels']}, not {want}")


# the fp32 grouped backward's first design, which no step may run
GROUPED_FP32_OLD = ("expert_h_kernel<true>", "dx_out_kernel", "dw_kernel")
# the fp32 grouped backward of the gated FFN: dX pass 1, pass 2 (FWD false)
# and dW
GROUPED_FP32_BWD = ("dw_tf32_kernel<true>", "dx_h_tf32_kernel<true, false>",
                    "dx_out_tf32_kernel<true, false>")
# and its forward: pass 1 of the gated kind and pass 2, which both kinds
# share (instantiated ungated)
GROUPED_FP32_FWD = ("dx_h_tf32_kernel<true, true>",
                    "dx_out_tf32_kernel<false, true>")
_TF32_GROUPED = ("dx_h_tf32_kernel", "dx_out_tf32_kernel", "dw_tf32_kernel")


def check_fp32_grouped_backward(tag, prof) -> None:
    """A profiled fp32 MoE step's grouped backward (the gated silu FFN of
    ``moe_fp32_config``): exactly the TF32 wgmma dX pass 1, pass 2 and dW
    instantiations of the gated kind (``GROUPED_FP32_BWD``), so no
    first-design ``expert_h_kernel<true>``, ``dx_out_kernel`` or
    ``dw_kernel`` and none of the ungated kind's."""
    ran = prof["grouped_kernels"]
    got = sorted(k_ for k_ in ran if k_.startswith(_TF32_GROUPED)
                 and _grouped_pass(k_) != "fwd")
    old = [k_ for k_ in ran if k_.startswith(GROUPED_FP32_OLD)]
    if got != sorted(GROUPED_FP32_BWD) or old:
        raise AssertionError(f"{tag}: the fp32 grouped backward ran {ran}, "
                             f"not {sorted(GROUPED_FP32_BWD)}")


def check_fp32_grouped_forward(tag, prof) -> None:
    """A profiled fp32 MoE step's grouped forward (the gated silu FFN):
    exactly the TF32 wgmma FWD instantiations of the gated kind
    (``GROUPED_FP32_FWD``), so no ungated pass 1 and no first-design
    ``expert_h_kernel`` or ``fwd_out_kernel``."""
    ran = prof["grouped_kernels"]
    got = sorted(k_ for k_ in ran if k_.startswith(_TF32_GROUPED)
                 and _grouped_pass(k_) == "fwd")
    old = [k_ for k_ in ran if k_.startswith(("expert_h_kernel",
                                              "fwd_out_kernel"))]
    if got != sorted(GROUPED_FP32_FWD) or old:
        raise AssertionError(f"{tag}: the fp32 grouped forward ran {ran}, "
                             f"not {sorted(GROUPED_FP32_FWD)}")


def _step_profile(torch, step_fn, model, opt, categories) -> dict:
    """One training step (``step_fn``) under the profiler: device time by
    kernel category (``categories``, then "other"), the idle share, the
    flash and grouped-GEMM kernels that ran (``flash_bwd_kernels``,
    ``flash_fwd_kernels``, ``grouped_kernels``), and the
    AdamW update alone (its device time under the profiler and its
    CUDA-event time on this step's gradients); ``other_without_adamw``
    takes the update out of "other"."""
    out = _profile_steps(torch, step_fn, 1, top=None)
    cats = {name: 0.0 for name, _ in categories}
    cats["other"] = 0.0
    ranked = out.pop("all_kernels_ms")
    out["grouped_passes"] = grouped_passes(out.pop("kernel_sequence"))
    out["routing_kernels"] = routing_kernels(k for k, _ in ranked)
    for kname, ms in ranked:
        cat = next((name for name, keys in categories
                    if any(k_ in kname for k_ in keys)), "other")
        cats[cat] += ms
    out["flash_bwd_kernels"] = flash_bwd_kernels(k for k, _ in ranked)
    out["flash_fwd_kernels"] = flash_fwd_kernels(k for k, _ in ranked)
    out["grouped_kernels"] = grouped_kernels(k for k, _ in ranked)
    params = dict(model.named_parameters())
    grads = {k: p.grad for k, p in params.items()}
    upd = _profile_steps(torch, lambda: opt.update(params, grads, opt.state,
                                                   lr=opt.get_lr()), 1)
    cats["adamw"] = upd["device_ms"] or 0.0
    cats["other_without_adamw"] = cats["other"] - cats["adamw"]
    out["device_ms_by_category"] = cats
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    opt.update(params, grads, opt.state, lr=opt.get_lr())
    end.record()
    torch.cuda.synchronize()
    out["optimizer_update_ms"] = start.elapsed_time(end)
    return out


def phase_train_moe_profile(torch, model, opt, TrainStep, batch,
                            tag="train_moe_profile", fwd_mode=None,
                            fp32=False) -> dict:
    """``_step_profile`` of one MoE training step, by category: the MoE
    expert kernels, the routing kernel, flash, RMSNorm, GEMMs, AdamW,
    everything else. ``fwd_mode`` (``"<64, false, false>"``), when given: the
    step's flash forward must be the wgmma kernel of that mode alone and
    its grouped forward the wgmma passes (``check_wgmma_forward``).
    ``fp32``: its flash forward and backward must be the plain TF32 wgmma
    kernels alone (``check_fp32_forward``, ``check_fp32_backward``), and
    its grouped forward, dX and dW the TF32 wgmma kernels of the gated FFN
    (``check_fp32_grouped_forward``, ``check_fp32_grouped_backward``). Its
    routing must be the tiled routing kernel."""
    step = TrainStep(model, opt, lambda logits, y: model.loss(logits, y))
    out = _step_profile(torch, lambda: step(batch, batch), model, opt,
                        _MOE_CATEGORIES)
    _emit(tag, out)
    if out["routing_kernels"] != ["routing_tiles_kernel"]:
        raise AssertionError(f"{tag}: the routing ran "
                             f"{out['routing_kernels']}, not the tiled kernel")
    if fwd_mode is not None:
        check_wgmma_forward(tag, out, fwd_mode, grouped=True)
    if fp32:
        check_fp32_forward(tag, out, bias=False, drop=False)
        check_fp32_backward(tag, out["flash_bwd_kernels"], drop=False)
        check_fp32_grouped_forward(tag, out)
        check_fp32_grouped_backward(tag, out)
    return out


# ---------------- the BERT pretraining path ----------------

BERT_BATCH, BERT_SEQ, BERT_STEPS = 32, 512, 10
BERT_PADDED_KERNELS = ("layer_norm", "flash_fwd_bias", "flash_dq_bias",
                       "flash_dkv_bias")


def bert_config(BertConfig):
    """``bench.py::bench_bert``'s configuration (bench.py:372-439):
    BERT-Base at its published widths (vocab 30522, hidden 768, 12
    layers, 12 heads, FFN 3072, exact-erf GELU, 512 positions), bf16,
    both dropouts 0. Full width and depth."""
    return BertConfig(dtype="bfloat16", hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0)


def bert_batch(torch, np, cfg, padded: bool, seed: int = SEED + 11):
    """One fixed batch of 32 x 512 and its ``TrainStep`` arguments.

    Unpadded (``train_bert``, exactly ``bench_bert``'s step): input ids
    only and random MLM labels over the whole vocabulary, ``(ids, (mlm,
    nsp))``. Padded (``train_bert_padded``): the valid lengths of
    :func:`bert_lengths`, ids 0 on padding, an ``attention_mask`` 1 on
    valid tokens, token types 0 up to a seeded split inside each row and
    1 after it (0 on padding), MLM labels -100 on padding: ``(ids,
    token types, mask, (mlm, nsp))``. ``seed`` draws the ids, labels
    and splits. Returns (arguments, n_inputs)."""
    rng = np.random.default_rng(seed)
    b, s = BERT_BATCH, BERT_SEQ
    ids = rng.integers(0, cfg.vocab_size, (b, s))
    mlm = rng.integers(0, cfg.vocab_size, (b, s))
    nsp = rng.integers(0, 2, (b,))

    def dev(a):
        return torch.tensor(a, dtype=torch.int64, device="cuda")

    if not padded:
        return (dev(ids), (dev(mlm), dev(nsp))), 1
    lens = bert_lengths(np)
    split = rng.integers(1, lens - 1)
    pos = np.arange(s)[None, :]
    mask = pos < lens[:, None]
    tt = (pos >= split[:, None]) & mask
    return (dev(np.where(mask, ids, 0)), dev(tt), dev(mask),
            (dev(np.where(mask, mlm, -100)), dev(nsp))), 3


def _bert_loss(model):
    return lambda out, labels: model.loss(*out, *labels)


def phase_train_bert(torch, K, model, TrainStep, AdamW, args, n_inputs,
                     smi, padded: bool) -> tuple:
    """10 TrainSteps of ``bench_bert``'s configuration on one fixed batch
    (``bert_batch``): step wall times, the median of steps 3-10,
    tokens/s (32 x 512 positions a step; the padded arm also reports its
    valid tokens), ``mfu`` = 6 N tokens/s over the 989 TFLOP/s bf16 peak
    (bench.py:429), peak memory, every loss, and the launch counters of
    this phase alone: per step 26 LayerNorm launches (the embeddings',
    two in each of 12 layers, ``mlm_norm``) and 12 of each flash kernel,
    in the no-bias mode unpadded and in the bias mode padded (and none
    of the other mode)."""
    cfg = model.config
    L = cfg.num_hidden_layers
    opt = AdamW(learning_rate=TRAIN_LR, parameters=model)
    step = TrainStep(model, opt, _bert_loss(model), n_inputs=n_inputs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    losses, times = [], []
    for _ in range(BERT_STEPS):
        t0 = time.perf_counter()
        loss = step(*args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    launches = K.launch_counts()
    n_params = model.num_params()
    step_s = statistics.median(times[2:])
    tokens = BERT_BATCH * BERT_SEQ
    out = {"config": cfg.__dict__, "params": n_params,
           "batch": BERT_BATCH, "seq": BERT_SEQ, "lr": TRAIN_LR,
           "padded": padded, "step_ms": [t * 1e3 for t in times],
           "median_step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
           "mfu": 6.0 * n_params * tokens / step_s / BF16_TENSOR_FLOPS,
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "losses": losses, "launches": launches, "card": smi}
    if padded:
        valid = int(args[2].sum())
        out["valid_tokens"] = valid
        out["valid_tokens_per_s"] = valid / step_s
    _emit("train_bert_padded" if padded else "train_bert", out)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall on a fixed batch: "
                             f"{losses}")
    n = L * BERT_STEPS
    flash = ({"flash_fwd_bias": n, "flash_dq_bias": n, "flash_dkv_bias": n}
             if padded else {"flash_fwd": n, "flash_dq": n, "flash_dkv": n})
    want = _counts(K, layer_norm=(2 * L + 2) * BERT_STEPS, **flash)
    if launches != want:
        raise AssertionError(f"launch counters {launches} != expected "
                             f"{want} over {BERT_STEPS} steps")
    return out, opt


# BERT train parity limits (see phase_train_bert_parity)
BERT_PARITY = (0.1, 0.15, PARITY_DPARAM)


def fp32_grads(torch, K, model, cls, args, n_inputs, loss_of,
               state=None) -> dict:
    """One step's gradients of an fp32 copy of ``model`` (a ``cls``; its
    current weights, exact in fp32) on ``args``, in training mode through
    the plain versions, with ``loss_of(copy)`` as the loss: the reference
    ``train_parity_run`` measures bf16's own error against. ``state``:
    the generator state the copy draws its dropout masks and keys from."""
    cfg = dataclasses.replace(model.config, dtype="float32")
    ref = cls(cfg, device=next(model.parameters()).device, seed=None)
    with torch.no_grad():
        for (k, p), (k32, p32) in zip(model.named_parameters(),
                                      ref.named_parameters()):
            assert k == k32
            p32.copy_(p.float())
    if state is not None:
        ref.generator.set_state(state)
    ref.train()
    with K.plain_reference():
        out = ref(*args[:n_inputs])
        loss_of(ref)(out, *args[n_inputs:]).backward()
    grads = {k: p.grad.detach().clone() for k, p in ref.named_parameters()}
    del ref, out
    torch.cuda.empty_cache()
    return grads


def bert_noise_by_layer(noise: dict, n_layers: int) -> dict:
    """``bf16_noise`` of each layer's attention projections, by layer."""
    return {i: {side: noise[f"bert.encoder.layers.{i}.self_attn.{side}"
                            f".weight"]
                for side in ("q_proj", "k_proj", "v_proj", "out_proj")}
            for i in range(n_layers)}


def bert_parity_run(torch, K, model, opt, TrainStep, BertForPreTraining,
                    args, n_inputs) -> dict:
    """``train_parity_run`` on a BERT batch with ``BERT_PARITY`` and the
    fp32 gradients of ``fp32_grads`` as ``grad_ref``; see
    ``phase_train_bert_parity``."""
    ref = fp32_grads(torch, K, model, BertForPreTraining, args, n_inputs,
                     _bert_loss)
    out = train_parity_run(
        torch, K, model, opt, TrainStep, _bert_loss(model), args, n_inputs,
        kernels=BERT_PADDED_KERNELS, limits=BERT_PARITY, grad_ref=ref)
    out["bf16_noise_by_layer"] = bert_noise_by_layer(
        out["bf16_noise"], model.config.num_hidden_layers)
    out["bf16_noise_max_resolved"] = max(
        (v, k) for k, v in out["bf16_noise"].items()
        if k not in out["unresolved"])
    return out


def phase_train_bert_parity(torch, K, model, opt, TrainStep,
                            BertForPreTraining, args, n_inputs) -> dict:
    """``bert_parity_run`` on the padded BERT batch, from the state the
    padded phase leaves: three steps through the kernels (LayerNorm and
    the bias mode of the three flash kernels must launch) and inside
    ``plain_reference()``, and one step of an fp32 copy of the same
    weights through the plain versions.

    Limits (``BERT_PARITY``), derived as the Llama step's: a few times
    the differences of the correct kernels (PERF.md), and the master
    weights a quarter of the 6 lr that three Adam steps can put between
    two runs. The correct kernels gave (NVIDIA H100 80GB HBM3, 700 W)
    |loss difference| 0.032 at a loss of ~97, whose MLM logits (|logit|
    up to ~100 through the N(0, 1) tied embedding) round at 2**-3 to
    2**-1 in bf16; gradients 0.046 in relative L2 at most
    (``bert.pooler_dense.weight``: the NSP path's gradients average over
    the 32 [CLS] rows only; bf16 alone moves it by more than 0.075, and
    among the gradients it resolves the worst is 0.021); master weights
    4.9e-5 apart. Limits: |loss difference| <= 0.1 a step, every
    gradient <= 0.15, the master weights <= 1.5e-4 (as for Llama).

    Some gradients lie below bf16's resolution: in BERT-Base at this
    initialisation those of ``self_attn.q_proj`` and ``k_proj`` fall to
    1e-4 to 1e-2 of the value projection's in the deeper layers, and
    each key bias's exact gradient is 0 (the softmax cancels a bias
    added to a whole row of scores). Which ones is measured, not named:
    the fp32 copy's gradient tells, leaf by leaf, how far bf16 alone
    moves it (``bf16_noise``), and a leaf moved by more than half the
    gradient limit is held to the fp32 gradient instead
    (``train_parity_run``'s ``grad_ref`` rule). ``bf16_noise_by_layer``
    reports the attention projections' readings."""
    out = bert_parity_run(torch, K, model, opt, TrainStep,
                          BertForPreTraining, args, n_inputs)
    _emit("train_bert_parity", {k: v for k, v in out.items()
                                if k not in ("grad_rel_l2", "bf16_noise")})
    if out["failures"]:
        raise AssertionError(f"BERT train parity beyond tolerance: "
                             f"{out['failures']}")
    return out


_BERT_CATEGORIES = (("layer_norm", ("layer_norm_fwd_kernel",)),
                    ("flash", ("flash_",)),
                    ("gemm", ("nvjet", "gemm", "xmma", "cutlass", "cublas")))


def phase_train_bert_profile(torch, model, opt, TrainStep, args,
                             n_inputs, tag="train_bert_profile",
                             wgmma_mode=None, fwd_mode=None) -> dict:
    """``_step_profile`` of one BERT training step (the padded arm; with
    ``tag`` ``train_bert_profile_unpadded`` the unpadded one), by
    category: the LayerNorm kernel, the flash kernels, GEMMs, AdamW,
    everything else. ``wgmma_mode`` (``"<64, true, false>"``: the padded
    arm's bias mode), when given: the step's flash backward must be the
    wgmma dQ and dK/dV kernels of that mode alone
    (``check_wgmma_backward``); ``fwd_mode`` (``"<64, true, false>"``): its
    flash forward must be the wgmma kernel of that mode alone
    (``check_wgmma_forward``)."""
    step = TrainStep(model, opt, _bert_loss(model), n_inputs=n_inputs)
    out = _step_profile(torch, lambda: step(*args), model, opt,
                        _BERT_CATEGORIES)
    _emit(tag, out)
    if wgmma_mode is not None:
        check_wgmma_backward(tag, out["flash_bwd_kernels"], wgmma_mode)
    if fwd_mode is not None:
        check_wgmma_forward(tag, out, fwd_mode)
    return out


# ---------------- entry()'s fp32 model, GPT-2 small, BERT's defaults ------

def entry_config(LlamaConfig):
    """``__graft_entry__.py::entry()``'s flagship Llama: vocab 8192, hidden
    512, ffn 1408, 4 layers, 8 heads / 4 KV heads of 64, at
    ``LlamaConfig``'s default dtype, float32."""
    return LlamaConfig(vocab_size=8192, hidden_size=512,
                       intermediate_size=1408, num_hidden_layers=4,
                       num_attention_heads=8, num_key_value_heads=4,
                       max_position_embeddings=2048, mp_axis=None,
                       fsdp_axis=None)


# entry()'s forward, kernels against plain_reference(): the largest
# |logit difference| (|logit| ~ 1-10). The fp32 kernels lie as close to
# fp64 as the plain fp32 versions do (flash_fp32), and the logits moved
# by 1.5e-6 (PERF.md); attention operands rounded to bf16 would move them
# by ~1e-2.
ENTRY_DLOGIT_LIMIT = 1e-4
# fp32 train parity limits (train_parity_run): per-step |loss difference|
# (measured 0 to 7.6e-6, one fp32 ulp of GPT-2's loss of ~85), each
# gradient's relative L2 (measured 1.3e-6 and 4.3e-6; bf16 operands would
# give ~1e-2), the weights after step 3 (max |difference|, measured
# 4.4e-6 and 7.4e-6): half of lr, the room Adam's epsilon 1e-8 leaves a
# gradient that is rounding noise of ~1e-9 (GPT-2's key bias, whose exact
# gradient is 0 since the softmax cancels it) to move its step by a
# fraction of lr.
FP32_PARITY = (1e-4, 1e-3, 5e-5)
FP32_KERNELS = ("flash_fwd_fp32", "flash_dq_fp32", "flash_dkv_fp32")


def phase_entry_fp32(torch, np, K, LlamaConfig, LlamaForCausalLM,
                     TrainStep, AdamW) -> dict:
    """``entry()``'s configuration in the port (``entry_config``), weights
    from seed 0 through ``init_random``, the ids ``entry()`` makes
    (``default_rng(0).integers(0, 8192, (2, 256))``): the forward in eval
    mode on the card (4 fp32 flash-forward launches, 9 RMSNorm) and again
    inside ``plain_reference()``, the largest |logit difference| within
    ``ENTRY_DLOGIT_LIMIT``; then 3 fp32 ``TrainStep``s (AdamW lr 1e-4),
    through the kernels and inside ``plain_reference()`` from one state
    (``train_parity_run`` at ``FP32_PARITY``: the fp32 flash forward, dQ
    and dK/dV must launch), and one profiled step (``_step_profile``:
    device time by category; its flash forward and backward must be the
    plain TF32 wgmma kernels alone, ``check_fp32_forward`` and
    ``check_fp32_backward``)."""
    cfg = entry_config(LlamaConfig)
    model = LlamaForCausalLM(cfg, device="cuda", seed=0)
    model.eval()
    ids = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 256)), device="cuda")
    K.reset_launch_counts()
    with torch.no_grad():
        logits = model(ids)
        torch.cuda.synchronize()
        launches = K.launch_counts()
        with K.plain_reference():
            ref = model(ids)
    dlogit = (logits - ref).abs().max().item()
    want = _counts(K, flash_fwd_fp32=cfg.num_hidden_layers,
                   rms_norm=2 * cfg.num_hidden_layers + 1)
    model.train()
    opt = AdamW(learning_rate=TRAIN_LR, parameters=model)
    parity = train_parity_run(torch, K, model, opt, TrainStep,
                              *causal_lm_args(model, ids),
                              kernels=FP32_KERNELS, limits=FP32_PARITY)
    loss_fn, args = causal_lm_args(model, ids)
    step = TrainStep(model, opt, loss_fn)
    prof = _step_profile(torch, lambda: step(*args), model, opt, _CATEGORIES)
    out = {"config": cfg.__dict__, "params": model.num_params(),
           "logits_shape": list(logits.shape), "dtype": str(logits.dtype),
           "finite": bool(torch.isfinite(logits).all()),
           "max_abs_dlogit": dlogit, "dlogit_limit": ENTRY_DLOGIT_LIMIT,
           "forward_launches": launches,
           "parity": {k: v for k, v in parity.items() if k != "grad_rel_l2"},
           "profile": {k: prof[k] for k in (
               "wall_ms", "device_ms", "idle_share", "device_ms_by_category",
               "flash_fwd_kernels", "flash_bwd_kernels")}}
    _emit("entry_fp32", out)
    check_fp32_forward("entry_fp32", prof, bias=False, drop=False)
    check_fp32_backward("entry_fp32", prof["flash_bwd_kernels"], drop=False)
    failures = list(parity["failures"])
    if launches != want:
        failures.append(f"forward launch counters {launches} != {want}")
    if not (out["finite"] and dlogit <= ENTRY_DLOGIT_LIMIT):
        failures.append(f"|logit difference| {dlogit} > "
                        f"{ENTRY_DLOGIT_LIMIT} (or non-finite logits)")
    if failures:
        raise AssertionError(f"entry_fp32: {failures}")
    del model, opt
    torch.cuda.empty_cache()
    return out


GPT2_BATCH, GPT2_SEQ, GPT2_STEPS = 8, 1024, 10
GPT2_KERNELS = ("flash_fwd_fp32_drop", "flash_dq_fp32_drop",
                "flash_dkv_fp32_drop")


def gpt2_config(GPTConfig, dtype="float32"):
    """GPT-2 small at its published defaults (``paddle_tpu/models/gpt.py:
    17-30``): vocab 50304, hidden 768, 12 layers of 12 heads of 64, FFN
    3072, 1024 positions, LayerNorm eps 1e-5, exact GELU, tied LM head,
    fp32, hidden and attention dropout 0.1; ``mp_axis=None`` (one card).
    Full width and depth."""
    return GPTConfig(mp_axis=None, dtype=dtype)


def phase_train_gpt2(torch, np, K, model, TrainStep, AdamW, batch,
                     smi) -> tuple:
    """10 ``TrainStep``s of GPT-2 small (``gpt2_config``) on one fixed
    batch of 8 x 1024 seeded ids (labels = inputs, shifted by the loss),
    AdamW lr 1e-4, dropout 0.1 drawn from the model's generator: per-step
    wall time, the median of steps 3-10, tokens/s, MFU (``6 N + 12 L s
    h`` FLOPs a token over the 989 TFLOP/s bf16 peak, as the other
    slices; beside it the same over the 67 TFLOP/s fp32 peak that bounds
    its fp32 GEMMs), peak memory, every loss, and the launch counters of
    this phase alone: per step 12 of each fp32 dropout flash kernel and
    25 LayerNorm (two a block and ``ln_f``)."""
    cfg = model.config
    L, S, H = cfg.num_hidden_layers, GPT2_SEQ, cfg.hidden_size
    opt = AdamW(learning_rate=TRAIN_LR, parameters=model)
    step = TrainStep(model, opt, lambda logits, y: model.loss(logits, y))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    losses, times = [], []
    for _ in range(GPT2_STEPS):
        t0 = time.perf_counter()
        loss = step(batch, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    launches = K.launch_counts()
    n_params = model.num_params()
    step_s = statistics.median(times[2:])
    tokens = GPT2_BATCH * S
    fpt = 6.0 * n_params + 12.0 * L * S * H
    out = {"config": cfg.__dict__, "params": n_params, "batch": GPT2_BATCH,
           "seq": S, "lr": TRAIN_LR, "step_ms": [t * 1e3 for t in times],
           "median_step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
           "mfu": fpt * tokens / step_s / BF16_TENSOR_FLOPS,
           "mfu_fp32_peak": fpt * tokens / step_s / FP32_FLOPS,
           "flops_per_token": fpt,
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "losses": losses, "launches": launches, "card": smi}
    _emit("train_gpt2", out)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall on a fixed batch: "
                             f"{losses}")
    n = L * GPT2_STEPS
    want = _counts(K, layer_norm=(2 * L + 1) * GPT2_STEPS,
                   **dict.fromkeys(GPT2_KERNELS, n))
    if launches != want:
        raise AssertionError(f"launch counters {launches} != expected "
                             f"{want} over {GPT2_STEPS} steps")
    return out, opt


def phase_train_gpt2_parity(torch, K, model, opt, TrainStep, batch) -> dict:
    """Three steps from one state through the kernels and inside
    ``plain_reference()`` (``train_parity_run`` at ``FP32_PARITY``), the
    model's generator restored to one state before each run, so both
    draw the same dropout masks and attention-dropout keys: the fp32
    dropout flash kernels must launch."""
    state = model.generator.get_state()
    out = train_parity_run(torch, K, model, opt, TrainStep,
                           *causal_lm_args(model, batch),
                           kernels=GPT2_KERNELS, limits=FP32_PARITY,
                           reseed=lambda: model.generator.set_state(state))
    _emit("train_gpt2_parity", {k: v for k, v in out.items()
                                if k != "grad_rel_l2"})
    if out["failures"]:
        raise AssertionError(f"GPT-2 train parity beyond tolerance: "
                             f"{out['failures']}")
    return out


_GPT2_CATEGORIES = (("flash", ("flash_",)),
                    ("layer_norm", ("layer_norm_fwd_kernel",)),
                    ("gemm", ("nvjet", "gemm", "xmma", "cutlass", "cublas",
                              "sgemm")))


def phase_train_gpt2_profile(torch, model, opt, TrainStep, batch) -> dict:
    """``_step_profile`` of one GPT-2 training step, by category: the
    flash kernels, LayerNorm, GEMMs, AdamW, everything else. Its flash
    forward and backward must be the TF32 wgmma dropout kernels alone
    (``check_fp32_forward``, ``check_fp32_backward``)."""
    step = TrainStep(model, opt, lambda logits, y: model.loss(logits, y))
    out = _step_profile(torch, lambda: step(batch, batch), model, opt,
                        _GPT2_CATEGORIES)
    _emit("train_gpt2_profile", out)
    check_fp32_forward("train_gpt2_profile", out, bias=False, drop=True)
    check_fp32_backward("train_gpt2_profile", out["flash_bwd_kernels"],
                        drop=True)
    return out


DEFAULTS_STEPS = 3


def _train_steps(torch, K, model, TrainStep, AdamW, args, n_inputs, loss_fn,
                 n_steps) -> tuple:
    """``n_steps`` TrainSteps (AdamW lr 1e-4) on ``args``: the losses, the
    step times and the launch counters of these steps alone; and the
    optimizer."""
    opt = AdamW(learning_rate=TRAIN_LR, parameters=model)
    step = TrainStep(model, opt, loss_fn, n_inputs=n_inputs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    losses, times = [], []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        losses.append(step(*args).item())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return {"losses": losses, "step_ms": [t * 1e3 for t in times],
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": K.launch_counts()}, opt


def phase_train_bert_defaults(torch, np, K, BertConfig, BertForPreTraining,
                              TrainStep, AdamW, smi) -> dict:
    """BERT-Base at its own defaults (``BertConfig()``: fp32, hidden and
    attention dropout 0.1, full width and depth) on ``train_bert_padded``'s
    batch: 3 steps, each launching 12 of each fp32 flash kernel in its
    bias + dropout mode (``_flash_bias_drop``) and 26 LayerNorm, with
    finite losses, and one profiled step (``profile``: device time by
    category, idle share; its flash forward and backward must be the
    TF32 wgmma ``<true, true>`` kernels alone, ``check_fp32_forward`` and
    ``check_fp32_backward``); then the
    same weights evaluated (eval mode: the fp32 bias-mode forward, 12)
    and 2 steps of ``bench_bert``'s dropout 0 at the default fp32 (the
    fp32 bias mode without dropout, 12 of each a step) and one profiled
    step of that arm (``no_dropout_profile``: the ``<true, false>``
    kernels alone)."""
    cfg = BertConfig()
    model = BertForPreTraining(cfg, device="cuda", seed=SEED)
    args, n_inputs = bert_batch(torch, np, cfg, padded=True)
    L = cfg.num_hidden_layers
    out = {"config": cfg.__dict__, "params": model.num_params(),
           "batch": BERT_BATCH, "seq": BERT_SEQ, "card": smi}
    out["defaults"], opt = _train_steps(torch, K, model, TrainStep, AdamW,
                                        args, n_inputs, _bert_loss(model),
                                        DEFAULTS_STEPS)
    out["profile"] = bert_defaults_profile(torch, model, opt, TrainStep,
                                           args, n_inputs, drop=True)
    model.eval()
    K.reset_launch_counts()
    with torch.no_grad():
        mlm, _ = model(*args[:n_inputs])
    out["eval_launches"] = K.launch_counts()
    out["eval_finite"] = bool(torch.isfinite(mlm).all())
    del mlm
    nodrop = BertForPreTraining(BertConfig(hidden_dropout_prob=0.0,
                                           attention_probs_dropout_prob=0.0),
                                device="cuda", seed=SEED)
    out["no_dropout"], opt = _train_steps(torch, K, nodrop, TrainStep,
                                          AdamW, args, n_inputs,
                                          _bert_loss(nodrop), 2)
    out["no_dropout_profile"] = bert_defaults_profile(
        torch, nodrop, opt, TrainStep, args, n_inputs, drop=False)
    _emit("train_bert_defaults", out)
    failures = []
    for arm, n_steps, mode in (("defaults", DEFAULTS_STEPS, "_fp32_drop_bias"),
                               ("no_dropout", 2, "_fp32_bias")):
        want = _counts(K, layer_norm=(2 * L + 2) * n_steps,
                       **{f"flash_{k}{mode}": L * n_steps
                          for k in ("fwd", "dq", "dkv")})
        if out[arm]["launches"] != want:
            failures.append(f"{arm}: launch counters {out[arm]['launches']}"
                            f" != {want}")
        if not all(math.isfinite(x) for x in out[arm]["losses"]):
            failures.append(f"{arm}: non-finite loss {out[arm]['losses']}")
    if out["eval_launches"] != _counts(K, layer_norm=2 * L + 2,
                                       flash_fwd_fp32_bias=L):
        failures.append(f"eval launch counters {out['eval_launches']}")
    if not out["eval_finite"]:
        failures.append("eval: non-finite MLM logits")
    if failures:
        raise AssertionError(f"train_bert_defaults: {failures}")
    del model, nodrop, opt
    torch.cuda.empty_cache()
    return out


def bert_defaults_profile(torch, model, opt, TrainStep, args, n_inputs,
                          drop) -> dict:
    """``_step_profile`` of one fp32 BERT training step (an arm of
    ``train_bert_defaults``) by ``_BERT_CATEGORIES``; its flash forward
    and backward must be the TF32 wgmma bias kernels of the arm's mode
    alone (``check_fp32_forward``, ``check_fp32_backward``: ``<true,
    drop>``)."""
    step = TrainStep(model, opt, _bert_loss(model), n_inputs=n_inputs)
    out = _step_profile(torch, lambda: step(*args), model, opt,
                        _BERT_CATEGORIES)
    tag = ("train_bert_defaults" + ("" if drop else "_no_dropout")
           + "_profile")
    check_fp32_forward(tag, out, bias=True, drop=drop)
    check_fp32_backward(tag, out["flash_bwd_kernels"], drop=drop, bias=True)
    return out


def _lm_loss(model):
    return lambda logits, y: model.loss(logits, y)


def dropout_bf16_arms(torch, np, GPTConfig, GPTForCausalLM, BertConfig,
                      BertForPreTraining):
    """The two bf16 dropout arms, one model at a time: GPT-2 small with
    ``dtype="bfloat16"`` (dropout 0.1, 8 x 1024 seeded ids) and BERT-Base
    with ``dtype="bfloat16"`` at its dropout 0.1 on the padded batch.
    Yields (arm, model, its class, TrainStep arguments, n_inputs, the
    loss of a model, LayerNorm launches a step, the flash counters'
    mode suffix, the wgmma backward's template arguments, the wgmma
    forward's)."""
    gcfg = gpt2_config(GPTConfig, dtype="bfloat16")
    batch = torch.tensor(np.random.default_rng(SEED + 14).integers(
        0, gcfg.vocab_size, (GPT2_BATCH, GPT2_SEQ)), device="cuda")
    yield ("gpt2_bf16", GPTForCausalLM(gcfg, device="cuda", seed=SEED),
           GPTForCausalLM, (batch, batch), 1, _lm_loss,
           2 * gcfg.num_hidden_layers + 1, "_drop", "<64, false, true>",
           "<64, false, true>")
    del batch
    torch.cuda.empty_cache()
    bcfg = BertConfig(dtype="bfloat16")
    args, n_inputs = bert_batch(torch, np, bcfg, padded=True)
    yield ("bert_bf16", BertForPreTraining(bcfg, device="cuda", seed=SEED),
           BertForPreTraining, args, n_inputs, _bert_loss,
           2 * bcfg.num_hidden_layers + 2, "_drop_bias", "<64, true, true>",
           "<64, true, true>")
    del args
    torch.cuda.empty_cache()


# bf16 dropout train parity limits per arm, (|loss difference| a step,
# every resolved gradient in relative L2, master weights, the unresolved
# gradients' ratio), set as BERT_PARITY was, from the correct kernels'
# readings (see phase_train_dropout_bf16), after DROP_BF16_STEPS steps.
DROP_BF16_STEPS = 10
DROP_BF16_PARITY = {"gpt2_bf16": (1e-2, 0.1, 4.5e-4, UNRESOLVED_RATIO),
                    "bert_bf16": (0.05, 0.1, 4.5e-4, 4.0)}


def dropout_bf16_parity_run(torch, K, model, opt, TrainStep, cls, args,
                            n_inputs, loss_of, limits, kernels) -> dict:
    """``train_parity_run`` at ``limits`` with the model's generator set
    to one state before each run, so the kernels' and the plain run draw
    the same nn-level dropout masks and the same Philox keys, and with the
    gradients of an fp32 copy from that state (``fp32_grads``) as
    ``grad_ref``."""
    state = model.generator.get_state()
    ref = fp32_grads(torch, K, model, cls, args, n_inputs, loss_of, state)
    out = train_parity_run(
        torch, K, model, opt, TrainStep, loss_of(model), args, n_inputs,
        kernels=kernels, limits=limits[:3], grad_ref=ref,
        reseed=lambda: model.generator.set_state(state),
        unresolved_ratio=limits[3])
    out.pop("bf16_noise")
    return out


def phase_train_dropout_bf16(torch, np, K, GPTConfig, GPTForCausalLM,
                             BertConfig, BertForPreTraining, TrainStep,
                             AdamW, smi) -> dict:
    """The bf16 dropout modes on their paths (``dropout_bf16_arms``):
    for each arm ``DROP_BF16_STEPS`` steps (finite losses; 12 of each
    bf16 dropout flash kernel a step, GPT-2 without a bias and BERT with
    its key-padding bias), one profiled step whose flash forward and
    backward must be the wgmma forward, dQ and dK/dV kernels in the arm's
    mode and no bf16 mma.sync kernel (``check_wgmma_forward``,
    ``check_wgmma_backward``), then ``train_dropout_bf16_parity``
    (``dropout_bf16_parity_run``): 3 steps through the kernels and 3
    inside ``plain_reference()`` from the state the profiled step
    leaves, both from one generator state, at ``DROP_BF16_PARITY``.

    Limits (``DROP_BF16_PARITY``), derived as ``BERT_PARITY``'s
    (``phase_train_bert_parity``): a few times the differences of the
    correct kernels. Their readings (NVIDIA H100 80GB HBM3, 700 W; after
    3 and after 10 steps) were, GPT-2: |loss difference| 1.3e-3 and
    2.1e-3 at a loss of ~80-100 (logits through the N(0, 1) tied
    embedding round coarsely in bf16), gradients 0.025 and 0.038 in
    relative L2 (``wpe``, the first block's MLP), master weights 2.4e-4
    apart both times; BERT: 0.014 and 3.0e-3, 0.014 and 0.032, 3.4e-4 and
    1.7e-4. Limits: |loss difference| 0.01 (GPT-2) and 0.05 (BERT) a
    step, every resolved gradient 0.1. The master weights part most in
    the word embeddings, whose rows of tokens outside the batch get only
    the tied head's tiny gradient, whose sign bf16 rounding can flip, and
    Adam moves such a weight by ~lr whatever its gradient's size; they
    are held to 4.5e-4, three quarters of the 6 lr that three steps can
    put between two runs (the Llama and BERT steps hold 1.5e-4, a
    quarter). A parameter whose plain bf16 gradient lies more than half
    the gradient limit from the fp32 copy's is held to that gradient
    instead (``train_parity_run``'s ``grad_ref`` rule): BERT's key
    biases, whose exact gradient is 0, lay 2.3 and 2.5 times as far from
    it as the plain version's, so their ratio is held to 4 (GPT-2 has no
    such parameter: ``UNRESOLVED_RATIO``)."""
    out, parity, failures = {"card": smi}, {}, []
    for (arm, model, cls, args, n_inputs, loss_of, n_ln, mode, wgmma,
         fwd) in dropout_bf16_arms(torch, np, GPTConfig, GPTForCausalLM,
                                   BertConfig, BertForPreTraining):
        L = model.config.num_hidden_layers
        out[arm], opt = _train_steps(torch, K, model, TrainStep, AdamW, args,
                                     n_inputs, loss_of(model),
                                     DROP_BF16_STEPS)
        want = _counts(K, layer_norm=n_ln * DROP_BF16_STEPS,
                       **{f"flash_{k}{mode}": L * DROP_BF16_STEPS
                          for k in ("fwd", "dq", "dkv")})
        if out[arm]["launches"] != want:
            failures.append(f"{arm}: launch counters "
                            f"{out[arm]['launches']} != {want}")
        if not all(math.isfinite(x) for x in out[arm]["losses"]):
            failures.append(f"{arm}: non-finite loss {out[arm]['losses']}")
        step = TrainStep(model, opt, loss_of(model), n_inputs=n_inputs)
        out[arm]["profile"] = _step_profile(
            torch, lambda: step(*args), model, opt,
            _BERT_CATEGORIES if arm.startswith("bert") else _GPT2_CATEGORIES)
        prof = out[arm]["profile"]
        for check in (lambda: check_wgmma_forward(arm, prof, fwd),
                      lambda: check_wgmma_backward(
                          arm, prof["flash_bwd_kernels"], wgmma)):
            try:
                check()
            except AssertionError as e:
                failures.append(str(e))
        parity[arm] = dropout_bf16_parity_run(
            torch, K, model, opt, TrainStep, cls, args, n_inputs, loss_of,
            DROP_BF16_PARITY[arm],
            ("layer_norm",) + tuple(f"flash_{k}{mode}"
                                    for k in ("fwd", "dq", "dkv")))
        failures += [f"{arm} parity: {f}" for f in parity[arm]["failures"]]
        for p in model.parameters():
            p.grad = None
        del model, opt, step
        torch.cuda.empty_cache()
    _emit("train_dropout_bf16", out)
    _emit("train_dropout_bf16_parity", {
        arm: {k: v for k, v in r.items() if k != "grad_rel_l2"}
        for arm, r in parity.items()})
    if failures:
        raise AssertionError(f"train_dropout_bf16: {failures}")
    return out


# Slice parity's bound on the largest logit difference between the
# kernels and the plain versions over one decode step. Each layer's
# attention output moves by at most a bf16 ulp between the two; at 32
# layers of Llama-3-8B widths the logits moved by 0.012-0.014 (bf16 and
# int8 pools, PR 4's chip runs), so 0.1 leaves ~7x room. Without it the
# decisive-row rule alone passes any large error: it leaves no decisive
# row.
SLICE_DLOGIT_LIMIT = 0.1


def parity_run(torch, np, model, ServingEngine, K,
               kv_quant: bool = False) -> dict:
    """One decode step on one engine state, kernels vs plain versions
    (with ``kv_quant``, the int8 pool: the paged kernel's int8 mode).
    The largest logit difference must stay within SLICE_DLOGIT_LIMIT,
    greedy tokens must agree on every decisive row (top-2 margin over
    twice that difference), and the kernel run must launch RMSNorm
    2L + 1 times and the paged kernel, in its pool's mode, L times.
    Returns the numbers and a list of failures."""
    cfg = model.config
    eng = ServingEngine(model, num_pages=128, page_size=16, max_slots=8,
                        prefill_chunk=64, max_pages_per_slot=16,
                        kv_quant=kv_quant)
    rng = np.random.default_rng(SEED + 2)
    for n in rng.integers(16, 128, size=8):
        eng.add_request(rng.integers(0, cfg.vocab_size, n).tolist(), 8)
    while eng.scheduler.waiting or any(
            r.prefilling or not r.tokens
            for r in eng.scheduler.running.values()):
        eng.step()
    K.reset_launch_counts()
    got = eng.decode_logits().float()
    launches = K.launch_counts()
    with K.plain_reference():
        want = eng.decode_logits().float()
    torch.cuda.synchronize()
    delta = (got - want).abs().max().item()
    top2 = want.topk(2, dim=-1).values
    decisive = (top2[:, 0] - top2[:, 1]) > 2 * delta
    agree = got.argmax(-1) == want.argmax(-1)
    out = {"max_abs_dlogit": delta, "rows": int(got.shape[0]),
           "decisive_rows": int(decisive.sum()),
           "decisive_agree": int((agree & decisive).sum()),
           "all_rows_agree": int(agree.sum()), "launches": launches,
           "failures": []}
    if not delta <= SLICE_DLOGIT_LIMIT:
        out["failures"].append(f"max |dlogit| {delta} > "
                               f"{SLICE_DLOGIT_LIMIT}")
    if not bool(agree[decisive].all()):
        out["failures"].append("a decisive row disagrees")
    L = cfg.num_hidden_layers
    paged = "paged_attention_int8" if kv_quant else "paged_attention"
    if launches != _counts(K, rms_norm=2 * L + 1, **{paged: L}):
        out["failures"].append(f"the decode step launched {launches}")
    return out


def phase_parity(torch, np, model, ServingEngine, K,
                 kv_quant: bool = False) -> dict:
    out = parity_run(torch, np, model, ServingEngine, K, kv_quant)
    _emit("slice_parity_int8" if kv_quant else "slice_parity", out)
    if out["failures"]:
        raise AssertionError(f"kernel and plain decode steps differ: {out}")
    return out


def phase_serve(torch, np, model, ServingEngine, K, smi: str,
                kv_quant: bool = False) -> dict:
    """8 requests x 32 greedy tokens at the model's widths. Requests 0
    and 2-6 arrive first (prompt lengths from default_rng(0), 64..255);
    request 1 repeats request 0's first 64 tokens and arrives once
    request 0's prompt is cached (a full-page prefix hit); request 7 is
    a follow-up turn of request 0 — its prompt, its reply and 16 new
    tokens — arriving after request 0 finished, so it maps request 0's
    pages including the partial last one through a copy-on-write. With
    ``kv_quant`` the same trace runs over the int8 pool (``serve_int8``);
    the decode steps must then take the paged kernel's int8 mode only."""
    from paddle_tpu_torch.quantization import serving_state_bytes
    cfg = model.config
    L = cfg.num_hidden_layers
    new_tokens = 32
    rng = np.random.default_rng(SEED)
    lens = rng.integers(64, 256, size=7)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    if (len(prompts[0]) + new_tokens - 1) % 16 == 0:
        prompts[0] = prompts[0][:-1]   # keep request 0's last page partial
    prompts[1][:64] = prompts[0][:64]
    eng = ServingEngine(model, num_pages=256, page_size=16, max_slots=8,
                        prefill_chunk=64, max_pages_per_slot=32,
                        kv_quant=kv_quant)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    for i in (0, 2, 3, 4, 5, 6):
        eng.add_request(prompts[i], new_tokens, rid=f"r{i}")
    while not eng.request("r0").tokens:
        eng.step()
    eng.add_request(prompts[1], new_tokens, rid="r1")
    while not eng.request("r0").done:
        eng.step()
    follow = (prompts[0] + eng.request("r0").tokens
              + rng.integers(0, cfg.vocab_size, 16).tolist())
    eng.add_request(follow, new_tokens, rid="r7")
    res = eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launch_counts()
    steps = dict(eng.step_counts)
    summary = eng.metrics.summary()
    audit = eng.audit_pool()
    tokens = sum(len(t) for t in res.values())
    out = {"layers": L, "requests": len(res), "tokens": tokens,
           "wall_s": wall, "tokens_per_s": tokens / wall,
           "ttft_p50_s": summary["ttft_p50_s"],
           "ttft_p99_s": summary["ttft_p99_s"],
           "itl_p50_s": summary["itl_p50_s"],
           "itl_p99_s": summary["itl_p99_s"],
           "tpot_mean_s": summary["tpot_mean_s"],
           "step_counts": steps, "launches": launches,
           "prefix_hits": summary["prefix_hits"],
           "prefix_cow_copies": summary["prefix_cow_copies"],
           "preemptions": summary["preemptions"],
           "serving_state_bytes": serving_state_bytes(model),
           "kv_bytes_per_token": eng.pool.kv_bytes_per_token(),
           "kv_quant": eng.stats()["kv_quant"],
           "kv_quant_scale_max": summary["kv_quant_scale_max"],
           "kv_quant_err_bound": summary["kv_quant_err_bound"],
           "prompt_lens": [len(p) for p in prompts] + [len(follow)],
           "audit": audit, "card": smi}
    _emit("serve_int8" if kv_quant else "serve", out)
    out["streams"] = res
    bad = {r: len(t) for r, t in res.items() if len(t) != new_tokens}
    if len(res) != 8 or bad:
        raise AssertionError(f"requests did not all finish with "
                             f"{new_tokens} tokens: {bad}")
    dispatches = steps["decode"] + steps["mixed"]
    paged = "paged_attention_int8" if kv_quant else "paged_attention"
    want = _counts(K, rms_norm=(2 * L + 1) * dispatches,
                   **{paged: L * steps["decode"]})
    if launches != want or not (launches["rms_norm"] and launches[paged]):
        raise AssertionError(f"launch counters {launches} != expected "
                             f"{want} for step counts {steps}")
    if summary["prefix_hits"] < 2 or summary["prefix_cow_copies"] < 1:
        raise AssertionError(f"expected a prefix hit and a copy-on-write: "
                             f"{summary}")
    return out


def _int8_linears_device_ms(torch, model, rows: int):
    """Device time of every ``Int8ServingLinear`` of ``model`` called
    once on ``[rows, in]`` bf16 activations (the profiler's summed GPU
    activity): the int8 weight products of one step of ``rows`` tokens."""
    from paddle_tpu_torch.quantization import Int8ServingLinear
    layers = [m for m in model.modules() if isinstance(m, Int8ServingLinear)]
    xs = {m.in_features: torch.randn((rows, m.in_features), device="cuda")
          .bfloat16() for m in layers}

    def run():
        for m in layers:
            m(xs[m.in_features])
    with torch.no_grad():
        run()
        return _profile_steps(torch, run, 1)["device_ms"]


def phase_profile(torch, np, model, ServingEngine,
                  kv_quant: bool = False) -> dict:
    """Where a step's time goes at this depth: one mixed step (8 slots,
    each a 64-token prefill chunk) and then three decode steps, each
    under ``torch.profiler`` (see ``_profile_steps``). With ``kv_quant``
    (``profile_int8``, over the int8-weight model) also the device time
    of the ``Int8ServingLinear`` products of one step of each shape, and
    its share of that step's device time."""
    cfg = model.config
    eng = ServingEngine(model, num_pages=64, page_size=16, max_slots=8,
                        prefill_chunk=64, max_pages_per_slot=8,
                        kv_quant=kv_quant)
    rng = np.random.default_rng(SEED + 3)
    for _ in range(8):
        eng.add_request(rng.integers(0, cfg.vocab_size, 64).tolist(), 8)
    out = {name: _profile_steps(torch, eng.step, n_steps)
           for name, n_steps in (("mixed", 1), ("decode", 3))}
    if eng.step_counts != {"decode": 3, "mixed": 1}:
        raise AssertionError(f"profile phase ran {eng.step_counts}")
    if kv_quant:
        for name, rows in (("mixed", 8 * 64), ("decode", 8)):
            ms = _int8_linears_device_ms(torch, model, rows)
            step_ms = out[name]["device_ms"]
            out[name]["int8_linear_device_ms"] = ms
            out[name]["int8_linear_share"] = (ms / step_ms if ms and step_ms
                                              else None)
    _emit("profile_int8" if kv_quant else "profile",
          {"layers": cfg.num_hidden_layers, **out})
    return out


def _long_row(paged_long, mode) -> dict:
    """The long-context figures of one paged mode for the kernels line."""
    row = paged_long[mode]
    return {k: row[k] for k in ("ms", "device_ms", "bound_ms",
                                "library_ms", "library_device_ms",
                                "max_abs_err")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the serving model's depth to N decoder layers "
                         "(width is never cut); default: the full 32")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import paddle_tpu_torch.incubate.nn.functional as TI
        import paddle_tpu_torch.nn.functional as TF
        from paddle_tpu_torch import io as PIO
        from paddle_tpu_torch.jit import TrainStep
        from paddle_tpu_torch.models import (BertConfig, BertForPreTraining,
                                             GPTConfig, GPTForCausalLM,
                                             LlamaConfig, LlamaForCausalLM,
                                             Qwen2MoeConfig,
                                             Qwen2MoeForCausalLM, llama_3_8b)
        from paddle_tpu_torch.ops import kernels as K
        from paddle_tpu_torch.ops.kernels import build
        from paddle_tpu_torch.ops.kernels import flash_attention as F
        from paddle_tpu_torch.ops.kernels import moe_grouped_gemm as GG
        from paddle_tpu_torch.ops.kernels import moe_routing as MR
        from paddle_tpu_torch.optimizer import AdamW
        from paddle_tpu_torch import quantization as QZ
        from paddle_tpu_torch.serving import ServingEngine
    except ImportError as e:
        print(f"chip_smoke: the paddle_tpu_torch package is missing beside "
              f"this script ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = _nvidia_smi()
    print(f"device: {smi}", flush=True)
    _emit("versions", {"python": sys.version.split()[0],
                       "torch": torch.__version__,
                       "cuda": torch.version.cuda,
                       "device_name": torch.cuda.get_device_name(0),
                       "device_count": torch.cuda.device_count()})

    # 2. build
    t0 = time.perf_counter()
    built = build.build_all()
    build_s = time.perf_counter() - t0
    _emit("build", {"seconds": build_s,
                    "kernels": {n: {"built": b["built"],
                                    "ptxas": [ln for ln in b["log"].splitlines()
                                              if "registers" in ln
                                              or "spill" in ln]}
                                for n, b in built.items()}})

    probe_start = _host_probe_us(torch, K)

    # 3. kernel vs plain
    rms = phase_rms_norm(torch, K)
    paged = phase_paged(torch, K)
    paged_int8 = phase_paged_int8(torch, K, QZ)
    paged_long = phase_paged_long(torch, K, QZ)
    phase_paged_sweep(torch, K, QZ)
    torch.cuda.empty_cache()
    flash = phase_flash(torch, F)
    torch.cuda.empty_cache()
    ln = phase_layer_norm(torch, K)
    flash_bias = phase_flash_bias(torch, np, F)
    torch.cuda.empty_cache()
    flash_modes = phase_flash_fp32(torch, np, F)
    flash_modes.update(phase_flash_dropout(torch, np, F, K))
    torch.cuda.empty_cache()
    flash_varlen = phase_flash_varlen(torch, np, F, PIO)
    torch.cuda.empty_cache()
    varlen = phase_varlen_packed(torch, np, K, F, PIO, TF, TI)
    torch.cuda.empty_cache()
    moe_k = phase_moe_kernels(torch, MR, GG)
    torch.cuda.empty_cache()
    moe_fp32_k = phase_moe_fp32_kernels(torch, MR, GG)
    torch.cuda.empty_cache()

    # 4-6 on the training configuration, freed before the serving model
    cfg = flagship_config(LlamaConfig, TRAIN_SEQ)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", seed=SEED)
    torch.cuda.synchronize()
    _emit("train_model", {"init_s": time.perf_counter() - t0,
                          "params": model.num_params()})
    batch = torch.tensor(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ)), dtype=torch.int32,
        device="cuda")
    train, opt = phase_train(torch, K, model, TrainStep, AdamW, batch, smi)
    phase_train_parity(torch, K, model, opt, TrainStep, batch)
    train_prof = phase_train_profile(torch, model, opt, TrainStep, batch,
                                     "<128, false, false>")
    for p in model.parameters():
        p.grad = None
    del model, opt
    torch.cuda.empty_cache()

    # the Qwen2-MoE training configuration, freed before the serving model
    cfg = moe_config(Qwen2MoeConfig, MOE_SEQ)
    t0 = time.perf_counter()
    model = Qwen2MoeForCausalLM(cfg, device="cuda", seed=SEED)
    torch.cuda.synchronize()
    _emit("train_moe_model", {"init_s": time.perf_counter() - t0,
                              "params": model.num_params()})
    batch = torch.tensor(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (MOE_BATCH, MOE_SEQ)), dtype=torch.int32,
        device="cuda")
    train_moe, opt = phase_train_moe(torch, K, model, TrainStep, AdamW,
                                     batch, smi)
    phase_train_moe_parity(torch, K, model, opt, TrainStep, batch)
    moe_prof = phase_train_moe_profile(torch, model, opt, TrainStep, batch,
                                       fwd_mode="<64, false, false>")
    for p in model.parameters():
        p.grad = None
    del model, opt
    torch.cuda.empty_cache()

    # the same in fp32 at the expert width the fused gates admit in fp32
    cfg = moe_fp32_config(Qwen2MoeConfig, MOE_SEQ)
    print(f"train_moe_fp32 cut: {MOE_FP32_CUT}", flush=True)
    t0 = time.perf_counter()
    model = Qwen2MoeForCausalLM(cfg, device="cuda", seed=SEED)
    torch.cuda.synchronize()
    _emit("train_moe_fp32_model", {"init_s": time.perf_counter() - t0,
                                   "params": model.num_params()})
    train_moe_fp32, opt = phase_train_moe(
        torch, K, model, TrainStep, AdamW, batch, smi, tag="train_moe_fp32",
        cut=MOE_FP32_CUT)
    phase_train_moe_fp32_parity(torch, K, model, opt, TrainStep, batch)
    moe_fp32_prof = phase_train_moe_profile(
        torch, model, opt, TrainStep, batch, tag="train_moe_fp32_profile",
        fp32=True)
    for p in model.parameters():
        p.grad = None
    del model, opt
    torch.cuda.empty_cache()

    # bench_bert's configuration: the unpadded and the padded arm
    cfg = bert_config(BertConfig)
    t0 = time.perf_counter()
    model = BertForPreTraining(cfg, device="cuda", seed=SEED)
    torch.cuda.synchronize()
    _emit("train_bert_model", {"init_s": time.perf_counter() - t0,
                               "params": model.num_params()})
    init = {k: p.detach().clone() for k, p in model.named_parameters()}
    bert_args, n_inputs = bert_batch(torch, np, cfg, padded=False)
    train_bert, opt = phase_train_bert(torch, K, model, TrainStep, AdamW,
                                       bert_args, n_inputs, smi,
                                       padded=False)
    phase_train_bert_profile(torch, model, opt, TrainStep, bert_args,
                             n_inputs, "train_bert_profile_unpadded",
                             "<64, false, false>", "<64, false, false>")
    with torch.no_grad():   # the padded arm starts from the same weights
        for k, p in model.named_parameters():
            p.copy_(init[k])
    del init, opt
    bert_args, n_inputs = bert_batch(torch, np, cfg, padded=True)
    train_bert_padded, opt = phase_train_bert(
        torch, K, model, TrainStep, AdamW, bert_args, n_inputs, smi,
        padded=True)
    phase_train_bert_parity(torch, K, model, opt, TrainStep,
                            BertForPreTraining, bert_args, n_inputs)
    bert_prof = phase_train_bert_profile(
        torch, model, opt, TrainStep, bert_args, n_inputs,
        wgmma_mode="<64, true, false>", fwd_mode="<64, true, false>")
    for p in model.parameters():
        p.grad = None
    del model, opt, bert_args
    torch.cuda.empty_cache()

    # entry()'s fp32 model; GPT-2 small and BERT-Base at their defaults
    entry = phase_entry_fp32(torch, np, K, LlamaConfig, LlamaForCausalLM,
                             TrainStep, AdamW)
    cfg = gpt2_config(GPTConfig)
    t0 = time.perf_counter()
    model = GPTForCausalLM(cfg, device="cuda", seed=SEED)
    torch.cuda.synchronize()
    _emit("train_gpt2_model", {"init_s": time.perf_counter() - t0,
                               "params": model.num_params()})
    batch = torch.tensor(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (GPT2_BATCH, GPT2_SEQ)), device="cuda")
    train_gpt2, opt = phase_train_gpt2(torch, np, K, model, TrainStep,
                                       AdamW, batch, smi)
    phase_train_gpt2_parity(torch, K, model, opt, TrainStep, batch)
    gpt2_prof = phase_train_gpt2_profile(torch, model, opt, TrainStep,
                                         batch)
    for p in model.parameters():
        p.grad = None
    del model, opt, batch
    torch.cuda.empty_cache()
    bert_defaults = phase_train_bert_defaults(
        torch, np, K, BertConfig, BertForPreTraining, TrainStep, AdamW, smi)
    dropout_bf16 = phase_train_dropout_bf16(
        torch, np, K, GPTConfig, GPTForCausalLM, BertConfig,
        BertForPreTraining, TrainStep, AdamW, smi)

    # 7-9 on one model at Llama-3-8B widths
    cfg = llama_3_8b(dtype="bfloat16")
    if args.layers is not None:
        print(f"depth cut: {args.layers} of {cfg.num_hidden_layers} layers "
              f"(widths unchanged)", flush=True)
        cfg.num_hidden_layers = args.layers
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", seed=SEED)
    model.eval()
    torch.cuda.synchronize()
    _emit("model", {"config": cfg.__dict__, "init_s":
                    time.perf_counter() - t0,
                    "params": model.num_params(),
                    "memory_allocated_gb":
                    torch.cuda.memory_allocated() / 1e9})
    phase_parity(torch, np, model, ServingEngine, K)
    torch.cuda.empty_cache()
    _emit("host_probe_us", {"start": probe_start,
                            "before_serve": _host_probe_us(torch, K)})
    serve = phase_serve(torch, np, model, ServingEngine, K, smi)
    phase_profile(torch, np, model, ServingEngine)

    # the same model with int8 weights, over the int8 pool
    t0 = time.perf_counter()
    QZ.quantize_for_serving(model, inplace=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    _emit("model_int8", {"quantize_s": time.perf_counter() - t0,
                         "serving_state_bytes":
                         QZ.serving_state_bytes(model),
                         "memory_allocated_gb":
                         torch.cuda.memory_allocated() / 1e9})
    phase_parity(torch, np, model, ServingEngine, K, kv_quant=True)
    torch.cuda.empty_cache()
    serve_int8 = phase_serve(torch, np, model, ServingEngine, K, smi,
                             kv_quant=True)
    phase_profile(torch, np, model, ServingEngine, kv_quant=True)
    # information only: the int8 model is another model, so its greedy
    # streams may part from the bf16 ones
    agree = {}
    for rid, ref in serve["streams"].items():
        got = serve_int8["streams"][rid]
        agree[rid] = next((i for i, (a, b_) in enumerate(zip(ref, got))
                           if a != b_), min(len(ref), len(got)))
    _emit("int8_vs_bf16_streams", {"divergence_free_prefix": agree,
                                   "tokens_per_request": 32})

    # 10. the kernels line
    src = "paddle_tpu_torch/csrc/"
    kernels = [
        {"name": "rms_norm", "route": "cuda", "source": src + "rms_norm.cu",
         "replaces": "paddle_tpu/ops/pallas/fused_norm.py:59",
         "launches": serve["launches"]["rms_norm"],
         "train_launches": train["launches"]["rms_norm"],
         "max_abs_err": max(r["max_abs_err"] for r in rms),
         "ms": rms[0]["ms"], "plain_ms": rms[0]["plain_ms"],
         "bound_ms": rms[0]["bound_ms"], "bound_by": rms[0]["bound_by"],
         "library_ms": rms[0]["library_ms"], "shape": rms[0]["shape"]},
        {"name": "paged_attention", "route": "cuda",
         "source": src + "paged_attention.cu",
         "replaces": "paddle_tpu/ops/pallas/paged_attention.py:181",
         "launches": serve["launches"]["paged_attention"],
         "max_abs_err": paged["max_abs_err"], "ms": paged["ms"],
         "plain_ms": paged["plain_ms"], "bound_ms": paged["bound_ms"],
         "bound_by": paged["bound_by"], "library_ms": paged["library_ms"],
         "shape": paged["shape"], "long_context": _long_row(paged_long,
                                                            "bf16")},
        {"name": "paged_attention_int8", "route": "cuda",
         "source": src + "paged_attention.cu",
         "replaces": "paddle_tpu/ops/pallas/paged_attention.py:181",
         "launches": serve_int8["launches"]["paged_attention_int8"],
         "max_abs_err": paged_int8["max_abs_err"], "ms": paged_int8["ms"],
         "plain_ms": paged_int8["plain_ms"],
         "bound_ms": paged_int8["bound_ms"],
         "bound_by": paged_int8["bound_by"],
         "library_ms": paged_int8["library_ms"],
         "shape": paged_int8["shape"], "long_context": _long_row(paged_long,
                                                                 "int8")},
    ]
    # the instantiations that the profiled steps ran
    ran = {"flash_fwd": train_prof["flash_fwd_kernels"],
           "flash_fwd_bias": bert_prof["flash_fwd_kernels"],
           "moe_fwd": [k_ for k_ in moe_prof["grouped_kernels"]
                       if k_ in GROUPED_FWD],
           "moe_routing": moe_prof["routing_kernels"]}
    for name, source, line in (
            ("flash_fwd", "flash_fwd_wgmma.cuh", 242),
            ("flash_dq", "flash_bwd_wgmma.cuh", 558),
            ("flash_dkv", "flash_bwd_wgmma.cuh", 590)):
        row = flash[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src + source,
            "replaces": f"paddle_tpu/ops/pallas/flash_attention.py:{line}",
            "launches": train["launches"][name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"], **({"kernels": ran[name]}
                                      if name in ran else {})})
    kernels.append({
        "name": "layer_norm", "route": "cuda",
        "source": src + "layer_norm.cu",
        "replaces": "paddle_tpu/ops/pallas/fused_norm.py:127",
        "launches": train_bert["launches"]["layer_norm"],
        "padded_launches": train_bert_padded["launches"]["layer_norm"],
        "max_abs_err": max(r["max_abs_err"] for r in ln), "ms": ln[0]["ms"],
        "plain_ms": ln[0]["plain_ms"], "bound_ms": ln[0]["bound_ms"],
        "bound_by": ln[0]["bound_by"], "library_ms": ln[0]["library_ms"],
        "shape": ln[0]["shape"]})
    for name, source, line in (
            ("flash_fwd_bias", "flash_fwd_wgmma.cuh", 242),
            ("flash_dq_bias", "flash_bwd_wgmma.cuh", 558),
            ("flash_dkv_bias", "flash_bwd_wgmma.cuh", 590)):
        row = flash_bias[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src + source,
            "replaces": f"paddle_tpu/ops/pallas/flash_attention.py:{line}",
            "launches": train_bert_padded["launches"][name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"], **({"kernels": ran[name]}
                                      if name in ran else {})})
    # the fp32 and dropout modes, launches from the phase whose path runs
    # each: entry_fp32 (its forward and 3 kernel training steps) and
    # train_moe_fp32, train_gpt2, train_bert_defaults (its arms),
    # train_dropout_bf16
    entry_train = entry["parity"]["launches_kernels"]
    mode_launches = {
        "_fp32": {k: entry["forward_launches"][f"flash_{k}_fp32"]
                  + entry_train[f"flash_{k}_fp32"]
                  + train_moe_fp32["launches"][f"flash_{k}_fp32"]
                  for k in ("fwd", "dq", "dkv")},
        "_fp32_bias": {
            k: bert_defaults["no_dropout"]["launches"][f"flash_{k}_fp32_bias"]
            + bert_defaults["eval_launches"][f"flash_{k}_fp32_bias"]
            for k in ("fwd", "dq", "dkv")},
        "_fp32_drop": {k: train_gpt2["launches"][f"flash_{k}_fp32_drop"]
                       for k in ("fwd", "dq", "dkv")},
        "_fp32_drop_bias": {
            k: bert_defaults["defaults"]["launches"][
                f"flash_{k}_fp32_drop_bias"] for k in ("fwd", "dq", "dkv")},
        "_drop": {k: dropout_bf16["gpt2_bf16"]["launches"][f"flash_{k}_drop"]
                  for k in ("fwd", "dq", "dkv")},
        "_drop_bias": {
            k: dropout_bf16["bert_bf16"]["launches"][f"flash_{k}_drop_bias"]
            for k in ("fwd", "dq", "dkv")}}
    # the profiled steps whose fp32 instantiations the rows name
    ran_fp32 = {"_fp32": moe_fp32_prof, "_fp32_drop": gpt2_prof,
                "_fp32_bias": bert_defaults["no_dropout_profile"],
                "_fp32_drop_bias": bert_defaults["profile"]}
    # and the bf16 dropout forward's that each arm's profiled step ran
    ran_drop = {suffix: dropout_bf16[arm]["profile"]["flash_fwd_kernels"]
                for suffix, arm in (("_drop", "gpt2_bf16"),
                                    ("_drop_bias", "bert_bf16"))}
    for suffix, counts in mode_launches.items():
        # the bf16 modes run the wgmma kernels, forward and backward; the
        # fp32 ones (d 64 on these paths) the TF32 wgmma kernels
        fp32 = suffix in ran_fp32
        fwd = "flash_fwd_tf32.cuh" if fp32 else "flash_fwd_wgmma.cuh"
        bwd = "flash_bwd_tf32.cuh" if fp32 else "flash_bwd_wgmma.cuh"
        for kind, source, line in (
                ("fwd", fwd, 242), ("dq", bwd, 558), ("dkv", bwd, 590)):
            name = f"flash_{kind}{suffix}"
            row = flash_modes[name]
            if fp32:
                prof = ran_fp32[suffix]
                ran_k = prof["flash_fwd_kernels"] if kind == "fwd" else [
                    k_ for k_ in prof["flash_bwd_kernels"]
                    if k_.split("::")[-1].startswith(kind)]
            else:
                ran_k = ran_drop[suffix] if kind == "fwd" else None
            kernels.append({
                "name": name, "route": "cuda", "source": src + source,
                "replaces": f"paddle_tpu/ops/pallas/flash_attention.py:{line}",
                "launches": counts[kind],
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                "shape": row["shape"],
                **({"kernels": ran_k} if ran_k is not None else {})})
    # the segment mode: launches from varlen_packed, the slice's path
    for suffix in ("_seg", "_fp32_seg"):
        for kind, source, line in (
                ("fwd", "flash_attention_fwd.cu", 242),
                ("dq", "flash_attention_bwd.cu", 558),
                ("dkv", "flash_attention_bwd.cu", 590)):
            name = f"flash_{kind}{suffix}"
            row = flash_varlen[name]
            kernels.append({
                "name": name, "route": "cuda", "source": src + source,
                "replaces": f"paddle_tpu/ops/pallas/flash_attention.py:{line}",
                "launches": varlen["launches"][name],
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                "library_per_doc_ms": row["library_per_doc_ms"],
                "kept_pairs_per_head": row["kept_pairs_per_head"],
                "shape": row["shape"]})
    for name, line in (("moe_routing", "moe_routing.py:147"),
                       ("moe_fwd", "moe_grouped_gemm.py:263"),
                       ("moe_dx", "moe_grouped_gemm.py:371"),
                       ("moe_dw", "moe_grouped_gemm.py:485")):
        row = moe_k[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": src + ("moe_routing.cu" if name == "moe_routing"
                             else "moe_grouped_gemm.cu"),
            "replaces": f"paddle_tpu/ops/pallas/{line}",
            "launches": train_moe["launches"][name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"], **({"kernels": ran[name]}
                                      if name in ran else {})})
    # the fp32 grouped instantiations that train_moe_fp32's profiled step
    # ran, by pass (all on TF32 wgmma; each split launch with the pass
    # after it, grouped_passes)
    ran_fp32_moe = {name: moe_fp32_prof["grouped_passes"].get(kind, [])
                    for name, kind in (("moe_fwd_fp32", "fwd"),
                                       ("moe_dx_fp32", "dx"),
                                       ("moe_dw_fp32", "dw"))}
    for name, line in (("moe_fwd_fp32", "moe_grouped_gemm.py:263"),
                       ("moe_dx_fp32", "moe_grouped_gemm.py:371"),
                       ("moe_dw_fp32", "moe_grouped_gemm.py:485")):
        row = moe_fp32_k[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": src + "moe_grouped_gemm.cu",
            "replaces": f"paddle_tpu/ops/pallas/{line}",
            "launches": train_moe_fp32["launches"][name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"], "kernels": ran_fp32_moe[name]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"nvidia-smi: {_nvidia_smi()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
