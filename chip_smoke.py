#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--layers N]

Phases; any failure ends the run with a traceback and a non-zero exit:

1. device — the card's name and power limit (``nvidia-smi``);
2. build — every kernel from ``paddle_tpu_torch/csrc``, one ``nvcc`` per
   source, all started together;
3. kernel vs plain — each kernel against its plain PyTorch version in
   bf16 at its path's shapes (RMSNorm and paged decode at the serving
   shapes; flash forward, dQ and dK/dV at the training shape, plus
   ragged shapes), with its time (CUDA events over many launches, inputs
   rotated through more than the 50 MB L2), the plain version's time,
   the least time the card could take (the bound) and, as a yardstick
   only, one PyTorch call computing the same function;
4. train — the JAX package's one-chip training configuration
   (``bench.py::_llama_flagship``: 8 layers at full width, bf16, AdamW at
   lr 1e-4, batch 4 x seq 2048) with seeded random weights made on the
   card: 10 ``TrainStep``s on a fixed batch, step time, tokens/s, MFU,
   peak memory, every loss, and the launch counters read around this
   phase alone;
5. train parity — three steps from one state through the kernels and
   again inside ``plain_reference()``: per-step |loss difference|, the
   first step's gradients, and the parameters after step 3;
6. train profile — one training step under ``torch.profiler``;
7. slice parity — one decode step on one serving engine state, kernels
   vs plain versions;
8. serve — Llama-3-8B widths in bf16 with seeded random weights made on
   the card, 8 requests x 32 greedy tokens through ``ServingEngine``
   (including a prefix hit and a copy-on-write), the launch counters
   read around this phase alone;
9. profile — one mixed and three decode steps under ``torch.profiler``:
   host wall, device time, idle share and the top kernels per step;
10. a ``{"kernels": [...]}`` line for every ported kernel.

The card's name and power limit are printed again on the line before
the last; the last line is ``{"ok": true, "device": {...}}``. Without a
CUDA device, or without the repository around this file, it exits
non-zero before printing any result. ``--layers`` cuts the serving
model's depth (never width) and the cut is printed; the training phases
always run the full configuration.
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


def _sdpa_yardstick(torch, q, pk, pv, tables, seq_lens):
    """Gather + PyTorch's scaled_dot_product_attention over the same
    pages: the yardstick only (the port never calls it)."""
    b, _, h, d = q.shape
    kvh = pk.shape[2]
    kg = pk[tables.long()].reshape(b, -1, kvh, d).transpose(1, 2)
    vg = pv[tables.long()].reshape(b, -1, kvh, d).transpose(1, 2)
    S = kg.shape[2]
    mask = (torch.arange(S, device=q.device)[None, :]
            <= seq_lens.long()[:, None])[:, None, None, :]
    out = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), kg, vg, attn_mask=mask, enable_gqa=True)
    return out.transpose(1, 2)


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
    want = {"rms_norm": (2 * L + 1) * TRAIN_STEPS, "paged_attention": 0,
            "flash_fwd": L * TRAIN_STEPS, "flash_dq": L * TRAIN_STEPS,
            "flash_dkv": L * TRAIN_STEPS}
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


def train_parity_run(torch, K, model, opt, TrainStep, batch) -> dict:
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
    measurements and ``failures``, a list of the limits broken."""
    params = dict(model.named_parameters())
    snap_p = {k: p.detach().clone() for k, p in params.items()}
    snap_s = _clone_state(opt.state)
    runs = {}
    for name in ("kernels", "plain"):
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(snap_p[k])
        opt.state = _clone_state(snap_s)
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
        runs[name] = (losses, grads, master, K.launch_counts())
    (lk, gk, mk, ck), (lp, gp, mp, cp) = runs["kernels"], runs["plain"]
    dloss = [abs(a - b) for a, b in zip(lk, lp)]
    grad_rel = {k: ((gk[k].float() - gp[k].float()).norm()
                    / gp[k].float().norm().clamp(min=1e-30)).item()
                for k in gk}
    dparam = max((mk[k] - mp[k]).abs().max().item() for k in mk)
    worst = max(grad_rel, key=grad_rel.get)
    failures = []
    if any(cp.values()) or not all(ck[n] for n in
                                   ("flash_fwd", "flash_dq", "flash_dkv")):
        failures.append(f"the kernel run must launch the flash kernels "
                        f"and the plain run none: {ck} {cp}")
    if not max(dloss) <= PARITY_DLOSS:
        failures.append(f"|loss difference| {max(dloss)} > {PARITY_DLOSS}")
    if not grad_rel[worst] <= PARITY_GRAD_REL:
        failures.append(f"gradient {worst} {grad_rel[worst]} > "
                        f"{PARITY_GRAD_REL} in relative L2")
    if not dparam <= PARITY_DPARAM:
        failures.append(f"master weights {dparam} > {PARITY_DPARAM} apart")
    return {"losses_kernels": lk, "losses_plain": lp, "abs_dloss": dloss,
            "max_grad_rel_l2": grad_rel[worst], "worst_grad": worst,
            "grad_rel_l2": grad_rel, "max_abs_dparam_step3": dparam,
            "launches_kernels": ck, "launches_plain": cp,
            "failures": failures}


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


def phase_parity(torch, np, model, ServingEngine, K) -> dict:
    """One decode step on one engine state, kernels vs plain versions."""
    cfg = model.config
    eng = ServingEngine(model, num_pages=128, page_size=16, max_slots=8,
                        prefill_chunk=64, max_pages_per_slot=16)
    rng = np.random.default_rng(SEED + 2)
    for n in rng.integers(16, 128, size=8):
        eng.add_request(rng.integers(0, cfg.vocab_size, n).tolist(), 8)
    while eng.scheduler.waiting or any(
            r.prefilling or not r.tokens
            for r in eng.scheduler.running.values()):
        eng.step()
    got = eng.decode_logits().float()
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
           "all_rows_agree": int(agree.sum())}
    _emit("slice_parity", out)
    if not math.isfinite(delta) or not bool(agree[decisive].all()):
        raise AssertionError(f"kernel and plain decode steps disagree on a "
                             f"decisive row: {out}")
    return out


def phase_serve(torch, np, model, ServingEngine, K, smi: str) -> dict:
    """8 requests x 32 greedy tokens at the model's widths. Requests 0
    and 2-6 arrive first (prompt lengths from default_rng(0), 64..255);
    request 1 repeats request 0's first 64 tokens and arrives once
    request 0's prompt is cached (a full-page prefix hit); request 7 is
    a follow-up turn of request 0 — its prompt, its reply and 16 new
    tokens — arriving after request 0 finished, so it maps request 0's
    pages including the partial last one through a copy-on-write."""
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
                        prefill_chunk=64, max_pages_per_slot=32)
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
           "prompt_lens": [len(p) for p in prompts] + [len(follow)],
           "audit": audit, "card": smi}
    _emit("serve", out)
    bad = {r: len(t) for r, t in res.items() if len(t) != new_tokens}
    if len(res) != 8 or bad:
        raise AssertionError(f"requests did not all finish with "
                             f"{new_tokens} tokens: {bad}")
    dispatches = steps["decode"] + steps["mixed"]
    want = {"rms_norm": (2 * L + 1) * dispatches,
            "paged_attention": L * steps["decode"],
            "flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
    if launches != want or not (launches["rms_norm"]
                                and launches["paged_attention"]):
        raise AssertionError(f"launch counters {launches} != expected "
                             f"{want} for step counts {steps}")
    if summary["prefix_hits"] < 2 or summary["prefix_cow_copies"] < 1:
        raise AssertionError(f"expected a prefix hit and a copy-on-write: "
                             f"{summary}")
    return out


def phase_profile(torch, np, model, ServingEngine) -> dict:
    """Where a step's time goes at this depth: one mixed step (8 slots,
    each a 64-token prefill chunk) and then three decode steps, each
    under ``torch.profiler`` (see ``_profile_steps``)."""
    cfg = model.config
    eng = ServingEngine(model, num_pages=64, page_size=16, max_slots=8,
                        prefill_chunk=64, max_pages_per_slot=8)
    rng = np.random.default_rng(SEED + 3)
    for _ in range(8):
        eng.add_request(rng.integers(0, cfg.vocab_size, 64).tolist(), 8)
    out = {name: _profile_steps(torch, eng.step, n_steps)
           for name, n_steps in (("mixed", 1), ("decode", 3))}
    if eng.step_counts != {"decode": 3, "mixed": 1}:
        raise AssertionError(f"profile phase ran {eng.step_counts}")
    _emit("profile", {"layers": cfg.num_hidden_layers, **out})
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
                                             llama_3_8b)
        from paddle_tpu_torch.ops import kernels as K
        from paddle_tpu_torch.ops.kernels import build
        from paddle_tpu_torch.ops.kernels import flash_attention as F
        from paddle_tpu_torch.optimizer import AdamW
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
    flash = phase_flash(torch, F)
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
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"nvidia-smi: {_nvidia_smi()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
