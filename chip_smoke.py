#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--layers N]

Phases; any failure ends the run with a traceback and a non-zero exit:

1. device — the card's name and power limit (``nvidia-smi``);
2. build — every kernel from ``paddle_tpu_torch/csrc``, one ``nvcc`` per
   source, all started together;
3. kernel vs plain — each kernel against its plain PyTorch version in
   bf16 at its path's shapes (RMSNorm and paged decode, fp and int8
   modes, at the serving shapes; flash forward, dQ and dK/dV at the
   Llama training shape, plus ragged shapes; MoE routing and the
   grouped-GEMM forward, dX and dW at the Qwen2-MoE training shapes;
   the int8 paged mode and the MoE kernels launched twice for a bitwise
   repeat), with its time (CUDA events over many launches, inputs
   rotated through more than the 50 MB L2), the plain version's time,
   the least time the card could take (the bound) and, as a yardstick
   only, PyTorch calls computing the same products;
4. train — the JAX package's one-chip Llama training configuration
   (``bench.py::_llama_flagship``: 8 layers at full width, bf16, AdamW at
   lr 1e-4, batch 4 x seq 2048) with seeded random weights made on the
   card: 10 ``TrainStep``s on a fixed batch, step time, tokens/s, MFU,
   peak memory, every loss, and the launch counters read around this
   phase alone;
5. train parity — three steps from one state through the kernels and
   again inside ``plain_reference()``: per-step |loss difference|, the
   first step's gradients, and the parameters after step 3;
6. train profile — one training step under ``torch.profiler``;
7. train_moe, train_moe_parity, train_moe_profile — phases 4-6 for the
   JAX package's ``qwen2_moe_fused`` configuration (8 sparse layers of 16
   experts, top-2, full width, bf16, batch 8 x seq 1024), with
   ``mfu_active``, the aux losses and the dropped copies per layer;
8. slice parity — one decode step on one serving engine state, kernels
   vs plain versions (logits within ``SLICE_DLOGIT_LIMIT``, decisive
   rows equal, the kernels' launch counts);
9. serve — Llama-3-8B widths in bf16 with seeded random weights made on
   the card, 8 requests x 32 greedy tokens through ``ServingEngine``
   (including a prefix hit and a copy-on-write), the launch counters
   read around this phase alone;
10. profile — one mixed and three decode steps under ``torch.profiler``:
    host wall, device time, idle share and the top kernels per step;
11. serve_int8 — the same model after ``quantize_for_serving(inplace=
    True)`` (int8 weights) replays the serve trace over the int8 KV pool
    (``kv_quant=True``), after a slice-parity decode step of its own
    (``slice_parity_int8``): the int8 mode of the paged kernel must take
    every decode step and the fp mode none; then ``profile_int8`` (phase
    10 over the int8 model, with the ``Int8ServingLinear`` share of each
    step's device time) and, for information only, how many leading
    tokens of each int8 stream equal the bf16 stream of its request;
12. a ``{"kernels": [...]}`` line for every ported kernel.

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


def phase_paged(torch, K) -> dict:
    """Paged decode at the serving shapes: b=8 slots, h=32, kvh=8,
    d=128, page 16, 32-page tables; ragged lengths with k*16-1 and k*16
    values, one inactive slot and a ~300-token context. bf16 tolerance
    1e-2 absolute: two bf16 ulps at |out| < 2 — q, the probabilities and
    the output are each rounded to bf16, and a rounding can flip by one
    ulp when the fp32 sums before it run in another order."""
    b, h, kvh, d, ps, M = 8, 32, 8, 128, 16, 32
    lens = [15, 16, 127, None, 300, 64, 255, 200]   # None: inactive
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    n_pages = b * M + 1
    sets = []
    for _ in range(16):     # 16 x ~4 MB of live KV: cycles through L2
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
    got = K.paged_attention_cuda(*sets[0])
    torch.cuda.synchronize()
    want = K.paged_attention_plain(*sets[0])
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=0)
    err = (got.float() - want.float()).abs().max().item()
    lib_err = (_sdpa_yardstick(torch, *sets[0]).float()
               - want.float()).abs().max().item()
    positions = sum((n if n is not None else 0) + 1 for n in lens)
    nbytes = (2 * b * h * d * 2                  # q in, out
              + 2 * positions * kvh * d * 2      # live K and V rows
              + b * M * 4 + b * 4)               # tables, seq_lens
    flops = 4 * positions * h * d
    bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_TENSOR_FLOPS) * 1e3
    row = {
        "shape": {"b": b, "h": h, "kvh": kvh, "d": d, "page_size": ps,
                  "max_pages": M, "seq_lens": [n if n is not None else 0
                                               for n in lens],
                  "inactive_slots": [3]},
        "max_abs_err": err, "tolerance": "atol 1e-2 (two bf16 ulps)",
        "library_max_abs_err": lib_err,
        **_timings(torch, {
            "kernel": K.paged_attention_cuda,
            "plain": K.paged_attention_plain,
            "library": lambda *a: _sdpa_yardstick(torch, *a)}, sets),
        "bound_ms": bound,
        "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                     >= flops / BF16_TENSOR_FLOPS else "operations")}
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


def paged_int8_inputs(torch, QZ, gen, n_sets=24) -> list:
    """Argument sets of the int8 paged kernel at the serving shapes: b=8
    slots, h=32, kvh=8, d=128, page 16, 32-page tables, bf16 q, int8
    pools made by ``kv_quantize`` from normal values, the serve trace's
    decode contexts (``SERVE_CONTEXTS``), each slot on its own random
    pages. 24 sets of ~2.9 MB of live codes and scales cycle through
    more than the 50 MB L2."""
    b, h, kvh, d, ps, M = 8, 32, 8, 128, 16, 32
    n_pages = b * M + 1
    sets = []
    for _ in range(n_sets):
        perm = torch.randperm(n_pages - 1, generator=gen,
                              device="cuda") + 1
        tables = torch.zeros((b, M), dtype=torch.int32, device="cuda")
        for s, n in enumerate(SERVE_CONTEXTS):
            live = -(-(n + 1) // ps)
            tables[s, :live] = perm[s * M:s * M + live].int()
        seq = torch.tensor(SERVE_CONTEXTS, dtype=torch.int32, device="cuda")
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
    nbytes = (2 * b * h * d * 2                    # q in, out
              + 2 * positions * kvh * (d + 4)      # live codes and scales
              + b * M * 4 + b * 4)                 # tables, seq_lens
    flops = 4 * positions * h * d + 2 * positions * kvh * d   # + dequant
    bound = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3
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
        "bound_ms": bound, "bound_bytes": nbytes,
        "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                     >= flops / FP32_FLOPS else "operations")}
    _emit("kernel_vs_plain", {"name": "paged_attention_int8", **row})
    return row


def _flash_work(b, sq, sk, h, d, causal, kind):
    """(flops, bytes) one flash call needs: 2 * d flops per product
    (2 in the forward, 3 in dQ, 4 in dK/dV) for each (query row, key)
    pair the mask keeps — this run's causal shape, not the dense one —
    and each input read once and each output written once (bf16
    [b, s, h, d] tensors, fp32 [b, h, sq] lse and delta)."""
    off = sk - sq
    pairs = (sum(min(sk, max(0, r + off + 1)) for r in range(sq))
             if causal else sq * sk)
    n_products = {"fwd": 2, "dq": 3, "dkv": 4}[kind]
    flops = 2.0 * d * b * h * pairs * n_products
    qb, kb, stat = 2 * b * sq * h * d, 2 * b * sk * h * d, 4 * b * h * sq
    nbytes = {"fwd": 2 * qb + 2 * kb + stat,       # q k v in; out, lse
              "dq": 3 * qb + 2 * kb + 2 * stat,    # q k v dO lse delta; dq
              "dkv": 2 * qb + 4 * kb + 2 * stat,   # same in; dk, dv
              }[kind]
    return flops, nbytes


def _bound(flops, nbytes):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_TENSOR_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# Flash kernels against their plain versions, per output (out, dq, dk,
# dv): each row (one (b, s, h) vector of d elements) within
# FLASH_ROW_RTOL of that row's largest magnitude plus FLASH_ROW_ATOL, and
# the whole output within FLASH_FRO in relative Frobenius norm.
FLASH_ROW_RTOL, FLASH_ROW_ATOL, FLASH_FRO = 2 ** -7, 1e-3, 4e-3


def _flash_errors(torch, F, q, k, v, do, scale, causal) -> dict:
    """Each flash kernel against its plain version on the same inputs
    (the backward kernels from the plain forward's lse and delta).

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
    exact: out 0 and lse -1e30.

    Returns per output ``{"max_abs", "row", "fro"}`` (``row``: the worst
    row's error over its tolerance), ``lse`` and ``failures``, a list
    of what broke its tolerance."""
    q32, k32, v32, do32 = (x.float() for x in (q, k, v, do))
    want_o, want_l = F.flash_fwd_plain(q32, k32, v32, scale, causal)
    delta = F.flash_delta(do, want_o.to(q.dtype))
    got_o, got_l = F.flash_fwd_cuda(q, k, v, scale, causal)
    got_dq = F.flash_bwd_dq_cuda(q, k, v, do, want_l, delta, scale, causal)
    got_dk, got_dv = F.flash_bwd_dkv_cuda(q, k, v, do, want_l, delta,
                                          scale, causal)
    torch.cuda.synchronize()
    want_g = F.flash_block_grads_plain(q32, k32, v32, do32, want_l, delta,
                                       scale, causal)
    errs, failures = {}, []
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


def _flash_check(torch, F, *args) -> dict:
    errs = _flash_errors(torch, F, *args)
    if errs["failures"]:
        raise AssertionError(f"flash kernels differ from their plain "
                             f"versions: {errs}")
    return errs


def phase_flash(torch, F, shape=(4, 2048, 16, 128)) -> dict:
    """Flash forward, dQ and dK/dV at the training path's shape: q/k/v
    [4, 2048, 16, 128] bf16, causal (each of the 8 layers' attention),
    then three ragged shapes (s 1000 non-causal at d 64; causal with
    sq != sk both ways, off = -300 leaving rows that see no key, and
    off = +300). Times at the path's shape: the kernel, its plain version
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
    errs = [_flash_check(torch, F, *sets[0][:4], scale, True)]
    torch.cuda.empty_cache()
    with torch.no_grad():
        lib_out = torch.nn.functional.scaled_dot_product_attention(
            *lib_fwd[0], is_causal=True).transpose(1, 2)
    lib_err = (lib_out.float() - F.flash_fwd_plain(
        *sets[0][:3], scale, True)[0].float()).abs().max().item()
    ragged = [(2, 1000, 1000, 4, 64, False), (2, 1000, 700, 4, 64, True),
              (2, 700, 1000, 4, 128, True)]
    for rb, rsq, rsk, rh, rd, rc in ragged:
        errs.append(_flash_check(
            torch, F, rand(rb, rsq, rh, rd), rand(rb, rsk, rh, rd),
            rand(rb, rsk, rh, rd), rand(rb, rsq, rh, rd), rd ** -0.5, rc))
    _emit("flash_ragged", [{"shape": list(r), "errors": e}
                           for r, e in zip(ragged, errs[1:])])

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


FLASH_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")


def train_parity_run(torch, K, model, opt, TrainStep, batch,
                     kernels=FLASH_KERNELS,
                     limits=(PARITY_DLOSS, PARITY_GRAD_REL, PARITY_DPARAM),
                     reseed=None, probes=(), probe_limits=None) -> dict:
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

    ``kernels`` must launch in the kernel run; ``limits`` are the three
    limits above; ``reseed``, when given, is called before each run (a
    model that draws random numbers starts both runs from one state).
    ``probes`` names modules whose output and input gradient in the first
    step are compared too (relative L2, the worst module against
    ``probe_limits = (output, input gradient)``)."""
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
    for name in ("kernels", "plain"):
        seen = {mod_name: {} for mod_name, _ in probes}
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(snap_p[k])
        opt.state = _clone_state(snap_s)
        if reseed is not None:
            reseed()
        step = TrainStep(model, opt, lambda logits, y: model.loss(logits, y))
        K.reset_launch_counts()
        scope = (K.plain_reference() if name == "plain"
                 else contextlib.nullcontext())
        losses, grads = [], None
        with scope:
            for i in range(3):
                losses.append(step(batch, batch).item())
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
    dloss = [abs(a - b) for a, b in zip(lk, lp)]
    grad_rel = {k: ((gk[k].float() - gp[k].float()).norm()
                    / gp[k].float().norm().clamp(min=1e-30)).item()
                for k in gk}
    dparam = max((mk[k] - mp[k]).abs().max().item() for k in mk)
    worst = max(grad_rel, key=grad_rel.get)
    failures = []
    lim_loss, lim_grad, lim_param = limits
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
    probe_rel = {kind: {n: ((pk[n][kind] - pp[n][kind]).norm()
                            / pp[n][kind].norm().clamp(min=1e-30)).item()
                        for n in pk} for kind in ("out", "dx")}
    for kind, lim in zip(("out", "dx"), probe_limits or ()):
        worst_n = max(probe_rel[kind], key=probe_rel[kind].get)
        if not probe_rel[kind][worst_n] <= lim:
            failures.append(f"{worst_n} {kind} {probe_rel[kind][worst_n]} "
                            f"> {lim} in relative L2")
    return {"losses_kernels": lk, "losses_plain": lp, "abs_dloss": dloss,
            "max_grad_rel_l2": grad_rel[worst], "worst_grad": worst,
            "grad_rel_l2": grad_rel, "max_abs_dparam_step3": dparam,
            "launches_kernels": ck, "launches_plain": cp,
            "probe_rel_l2": probe_rel, "failures": failures}


def phase_train_parity(torch, K, model, opt, TrainStep, batch) -> dict:
    out = train_parity_run(torch, K, model, opt, TrainStep, batch)
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
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
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
    return out


_CATEGORIES = (("flash", ("flash_",)), ("rms_norm", ("rms_norm",)),
               ("gemm", ("nvjet", "gemm", "xmma", "cutlass", "cublas")))


def phase_train_profile(torch, model, opt, TrainStep, batch) -> dict:
    """Where a training step's time goes: one step under the profiler,
    its device time by kernel category (flash kernels, RMSNorm kernel,
    GEMMs, everything else: elementwise, casts, reductions, the loss and
    the optimizer), and the optimizer update alone, timed by CUDA events
    on that step's gradients."""
    step = TrainStep(model, opt, lambda logits, y: model.loss(logits, y))
    out = _profile_steps(torch, lambda: step(batch, batch), 1, top=None)
    cats = {name: 0.0 for name, _ in _CATEGORIES}
    cats["other"] = 0.0
    for kname, ms in out.pop("all_kernels_ms"):
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


def moe_errors(torch, GG, x, row_id, gate_w, wi, wg, wo, g) -> dict:
    """Each grouped-GEMM kernel against its plain version on the same
    inputs (dW from the kernel's own dX intermediates, so each kernel is
    held alone), by ``_row_errors`` with the flash rule; each kernel
    launched twice must give bitwise equal results. The dgw and h of an
    empty slot are not compared: the Pallas kernels compute them from
    row T - 1, the CUDA kernels leave 0."""
    out = GG.moe_fwd_cuda(x, row_id, gate_w, wi, wg, wo, "silu")
    out2 = GG.moe_fwd_cuda(x, row_id, gate_w, wi, wg, wo, "silu")
    dx, dgw, inter = GG.moe_dx_cuda(x, row_id, gate_w, wi, wg, wo, g, "silu")
    dx2, dgw2, inter2 = GG.moe_dx_cuda(x, row_id, gate_w, wi, wg, wo, g,
                                       "silu")
    dws = GG.moe_dw_cuda(x, row_id, gate_w, g, inter)
    dws2 = GG.moe_dw_cuda(x, row_id, gate_w, g, inter)
    torch.cuda.synchronize()
    occupied = (row_id < x.shape[0]).float()
    failures = []
    repeat = {"fwd": torch.equal(out, out2),
              "dx": torch.equal(dx, dx2) and torch.equal(dgw * occupied,
                                                         dgw2 * occupied),
              "dw": all(torch.equal(a, b) for a, b in zip(dws, dws2))}
    failures += [f"{k}: a second launch differs" for k, v in repeat.items()
                 if not v]
    errs = {}
    want = GG.moe_fwd_plain(x, row_id, gate_w, wi, wg, wo, "silu")
    errs["out"] = _row_errors(torch, out, want)
    del want
    wdx, wdgw, winter = GG.moe_dx_plain(x, row_id, gate_w, wi, wg, wo, g,
                                        "silu")   # winter: h rounded
    errs["dx"] = _row_errors(torch, dx, wdx)
    errs["dgw"] = _row_errors(torch, dgw * occupied, wdgw * occupied)
    del winter
    want_h = GG._forward_parts(x, row_id, wi, wg, "silu")[3]   # fp32
    errs["h"] = _row_errors(torch, inter[0] * occupied[..., None],
                            want_h * occupied[..., None])
    del wdx, wdgw, want_h
    for name, got, want in zip(("dw_in", "dw_gate", "dw_out"), dws,
                               GG.moe_dw_plain(x, row_id, gate_w, g, inter)):
        errs[name] = _row_errors(torch, got, want)
    for name, err in errs.items():
        failures += _fails(name, err)
    return {"errors": errs, "bitwise_repeat": repeat, "failures": failures}


def moe_inputs(torch, GG, MR, gen, T=MOE_BATCH * MOE_SEQ, E=16, D=1024,
               H=704):
    """Inputs of the MoE kernels at the training path's shapes: fp32
    logits ~ N(0, 1.5^2) (the router's scale at init) plus a per-expert
    offset rising from 0 to 1.5, so that, as in training, some experts
    fill their capacity (at T 8192: 4 of 16 full, 3410 of 16384 copies
    dropped) and every slot block is exercised; uniforms; the slot maps
    they route to (the plain routing and the fused dispatch's own
    packing, capacity 1280); x and g ~ N(0, 1) and weights ~ N(0, 1/K)
    for a product over K, so every product is O(1) and the tolerances'
    1e-3 absolute term is small beside it; all bf16 but the logits."""
    from paddle_tpu_torch.distributed import moe as M
    logits = (torch.randn((T, E), generator=gen, device="cuda") * 1.5
              + torch.linspace(0.0, 1.5, E, device="cuda"))
    u = torch.rand((T,), generator=gen, device="cuda")
    cap = int(1.25 * T * 2 / E)
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
                * std).bfloat16()

    return {"logits": logits, "u": u, "row_id": row_id.contiguous(),
            "gate_w": gate_w.contiguous(), "x": rand(T, D),
            "g": rand(T, D), "wi": rand(E, D, H, std=D ** -0.5),
            "wg": rand(E, D, H, std=D ** -0.5),
            "wo": rand(E, H, D, std=H ** -0.5), "capacity": cap,
            "cpad": cpad, "occupied": int((row_id < T).sum())}


def phase_moe_kernels(torch, MR, GG) -> dict:
    """The routing kernel and the three grouped-GEMM kernels at the
    Qwen2-MoE training shapes (T 8192, E 16, D 1024, H 704, cpad 1280),
    bf16 (fp32 logits): each against its plain version (routing by
    ROUTE_*; the grouped kernels by the flash rule, each row within
    2**-7 of its largest magnitude + 1e-3 and 4e-3 in relative Frobenius
    norm) and launched twice for a bitwise repeat; then the time of each
    (CUDA events and profiler device time), of its plain version, its
    bound from this run's occupied slots, and as a yardstick only the
    ``torch.bmm`` calls of its products over packed [16, 1280, *]
    buffers, without the gathers (none for routing)."""
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
    _emit("moe_kernel_check", {"routing": route, "grouped": grouped,
                               "occupied_slots": n, "slots": E * cpad})
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


def phase_train_moe(torch, K, model, TrainStep, AdamW, batch, smi) -> tuple:
    """10 TrainSteps of the ``qwen2_moe_fused`` configuration on one fixed
    batch (labels = inputs, as bench.py:488): step wall times, the median
    of steps 3-10, tokens/s, ``mfu_active`` (``6 * n_active * tokens/s``
    over the 989 TFLOP/s bf16 peak, bench.py:496), peak memory, every
    loss and aux loss, the dropped copies per layer in each step, and the
    launch counters of this phase alone (one routing, forward, dX and dW
    launch per layer and step)."""
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
    _emit("train_moe", out)
    if not all(math.isfinite(x) for x in losses + auxes):
        raise AssertionError(f"non-finite training loss: {losses} {auxes}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall on a fixed batch: "
                             f"{losses}")
    n = L * MOE_STEPS
    want = _counts(K, rms_norm=(2 * L + 1) * MOE_STEPS, flash_fwd=n,
                   flash_dq=n, flash_dkv=n, moe_routing=n, moe_fwd=n,
                   moe_dx=n, moe_dw=n)
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
        torch, K, model, opt, TrainStep, batch,
        kernels=FLASH_KERNELS + MOE_KERNELS, limits=MOE_PARITY,
        reseed=lambda: model.generator.manual_seed(SEED + 6),
        probes=moe_probes(model), probe_limits=MOE_PROBE_LIMITS)
    _emit("train_moe_parity", {k: v for k, v in out.items()
                               if k != "grad_rel_l2"})
    if out["failures"]:
        raise AssertionError(f"MoE train parity beyond tolerance: "
                             f"{out['failures']}")
    return out


_MOE_CATEGORIES = (
    ("moe_expert", ("expert_h_kernel", "fwd_out_kernel", "dx_out_kernel",
                    "dgw_reduce_kernel", "dw_kernel")),
    ("moe_routing", ("routing_kernel",)),) + _CATEGORIES


def phase_train_moe_profile(torch, model, opt, TrainStep, batch) -> dict:
    """One MoE training step under the profiler: device time by category
    (the MoE expert kernels, the routing kernel, flash, RMSNorm, GEMMs,
    everything else), the idle share, and the AdamW update alone (its
    device time under the profiler and its CUDA-event time on this
    step's gradients); ``other_without_adamw`` takes the update out of
    "other"."""
    step = TrainStep(model, opt, lambda logits, y: model.loss(logits, y))
    out = _profile_steps(torch, lambda: step(batch, batch), 1, top=None)
    cats = {name: 0.0 for name, _ in _MOE_CATEGORIES}
    cats["other"] = 0.0
    for kname, ms in out.pop("all_kernels_ms"):
        cat = next((name for name, keys in _MOE_CATEGORIES
                    if any(k_ in kname for k_ in keys)), "other")
        cats[cat] += ms
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
    _emit("train_moe_profile", out)
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
        from paddle_tpu_torch.jit import TrainStep
        from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
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
    flash = phase_flash(torch, F)
    torch.cuda.empty_cache()
    moe_k = phase_moe_kernels(torch, MR, GG)
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
    phase_train_profile(torch, model, opt, TrainStep, batch)
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
    phase_train_moe_profile(torch, model, opt, TrainStep, batch)
    for p in model.parameters():
        p.grad = None
    del model, opt
    torch.cuda.empty_cache()

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
         "shape": paged["shape"]},
        {"name": "paged_attention_int8", "route": "cuda",
         "source": src + "paged_attention.cu",
         "replaces": "paddle_tpu/ops/pallas/paged_attention.py:181",
         "launches": serve_int8["launches"]["paged_attention_int8"],
         "max_abs_err": paged_int8["max_abs_err"], "ms": paged_int8["ms"],
         "plain_ms": paged_int8["plain_ms"],
         "bound_ms": paged_int8["bound_ms"],
         "bound_by": paged_int8["bound_by"],
         "library_ms": paged_int8["library_ms"],
         "shape": paged_int8["shape"]},
    ]
    for name, source, line in (
            ("flash_fwd", "flash_attention_fwd.cu", 242),
            ("flash_dq", "flash_attention_bwd.cu", 558),
            ("flash_dkv", "flash_attention_bwd.cu", 590)):
        row = flash[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src + source,
            "replaces": f"paddle_tpu/ops/pallas/flash_attention.py:{line}",
            "launches": train["launches"][name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
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
            "shape": row["shape"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"nvidia-smi: {_nvidia_smi()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
