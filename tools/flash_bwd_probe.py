#!/usr/bin/env python3
"""A short first call for the bf16 flash kernels on a GPU: the backward
(``csrc/flash_bwd_wgmma.cuh``: dQ and dK/dV on wgmma, fed by TMA) and
the forward (``csrc/flash_fwd_wgmma.cuh``), each in its plain, bias,
dropout and bias + dropout modes.

    python3 tools/flash_bwd_probe.py [--report FILE] [--times] [--big]
    python3 tools/flash_bwd_probe.py --fp32 [--report FILE] [--times] [--big]

Builds the two flash sources (``ptxas``'s registers and spills per
instantiation, and ``nvcc``'s warnings, go to the file ``--report``
names), then holds the three flash kernels against their plain versions
with ``chip_smoke.py``'s flash check (``_flash_errors``: each row within
2**-7 of its largest magnitude + 1e-3, relative Frobenius error <= 4e-3;
lse within 1e-4, rows that see no key exact; every kernel launched
twice, bitwise equal) at small shapes that take
every branch of the kernels: d 64 and 128, causal and not, ragged
lengths (s 1, 63, 130, 1000), causal with sq > sk (rows that see no key)
and sq < sk, one q tile of a 128-row block past the end, and q, k, v, dO
as strided views of one fused [b, s, 4, h, d] tensor. Each shape runs in
every mode: plain; ``keypad``, a key-padding bias as BERT's (bool [b, 1,
1, sk] through ``attn_bias``: stride 0 on heads and queries, seeded
lengths from 2 to sk); ``dense``, a random fp32 [b, h, sq, sk] bias with
-inf at every 11th key from key 3 and one query row of -1e30 (a row that
sees no key); ``drop``, dropout p 0.1 on one Philox key; and
``keypad_drop`` and ``dense_drop``. With one key (sk 1) every row's
dS = P (dP - delta) is 0 in exact arithmetic (P = 1, dP = delta), so dq
and dk are 0 and held by the row rule alone: their relative Frobenius
error is a ratio of roundings. ``--big`` adds BERT-Base's [32, 512,
12, 64] non-causal (plain, keypad, keypad_drop) and the Llama training
shape [4, 2048, 16, 128] causal (plain, drop). ``--times`` times the
forward, dQ and dK/dV (CUDA events, 100 calls cycling three input sets
past the L2) at
the Llama shape (plain), BERT-Base's (plain, keypad, keypad_drop) and
GPT-2 small's [8, 1024, 12, 64] causal (drop). Prints one JSON line.

``--fp32`` does the same for the fp32 forward, dQ and dK/dV on TF32
wgmma (``csrc/flash_fwd_tf32.cuh`` and ``csrc/flash_bwd_tf32.cuh``, d 64
without segment ids: ``fwd_tf32_kernel<HAS_BIAS, DROP>``,
``dq_tf32_kernel<HAS_BIAS, DROP>``, ``dkv_tf32_kernel<HAS_BIAS,
DROP>``): ``ptxas``'s registers and spills of those twelve
instantiations (a spill fails the run), then ``chip_smoke.py``'s fp32
rule (``flash_fp32_errors``: each output within 2x the plain fp32
version's error from fp64 plus 2**-16 / 2**-18, lse within 2x the plain
version's plus the floor) and a bitwise repeat of the forward and the
backward, in the six modes above, at ``FP32_SMALL`` (s 1, 63, 130,
1000; causal and not; sq != sk both ways, with rows that see no key and
rows that see one key; at sk 1 dq and dk are 0 exactly and their errors
roundings of 0, so as in the bf16 check only dv is held to the rule
there: ``chip_smoke.py``'s ``one_key_checks`` hold a whole [4, 256, 4,
64] sk-1 batch to it) and on strided views of one fused tensor;
``--big`` adds GPT-2 small's, ``train_moe_fp32``'s and ``entry()``'s
shapes (plain, drop) and BERT-Base's (plain, keypad, keypad_drop);
``--times`` times the forward, dQ and dK/dV at GPT-2 small's shape
(plain, drop) and at BERT-Base's (plain, keypad, keypad_drop).
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SMALL = [   # (b, sq, sk, h, d, causal)
    (1, 256, 256, 2, 64, True), (1, 256, 256, 2, 128, True),
    (2, 130, 130, 3, 64, False), (2, 130, 130, 3, 128, False),
    (2, 1000, 1000, 4, 64, False), (2, 1000, 700, 4, 64, True),
    (2, 700, 1000, 4, 128, True), (1, 63, 63, 2, 128, True),
    (1, 1, 1, 2, 64, False), (1, 1, 300, 2, 128, True),
    (1, 300, 1, 2, 64, True), (3, 200, 200, 2, 128, True)]
BERT, LLAMA = (32, 512, 512, 12, 64, False), (4, 2048, 2048, 16, 128, True)
GPT2 = (8, 1024, 1024, 12, 64, True)
BIG = [(BERT, ("plain", "keypad", "keypad_drop")), (LLAMA, ("plain", "drop"))]
TIMES = [(LLAMA, "plain"), (BERT, "plain"), (BERT, "keypad"),
         (BERT, "keypad_drop"), (GPT2, "drop")]
# fp32 at d 64 (b, sq, sk, h, d, causal): one key for every row (sk 1),
# ragged ends, 128-row q tiles past the end, sq > sk causal (rows 0..59
# see no key, row 60 one) and sq < sk
FP32_SMALL = [(1, 1, 1, 2, 64, False), (2, 200, 1, 2, 64, False),
              (1, 63, 63, 2, 64, True), (2, 130, 130, 3, 64, False),
              (2, 130, 130, 3, 64, True), (2, 260, 200, 2, 64, True),
              (1, 300, 1, 2, 64, True), (1, 1, 300, 2, 64, True),
              (2, 1000, 700, 4, 64, True), (2, 700, 1000, 4, 64, True),
              (2, 1000, 1000, 4, 64, False)]
FP32_BIG = [(GPT2, ("plain", "drop")),
            ((8, 1024, 1024, 16, 64, True), ("plain", "drop")),
            ((2, 256, 256, 8, 64, True), ("plain", "drop")),
            (BERT, ("plain", "keypad", "keypad_drop"))]
FP32_TIMES = [(GPT2, "plain"), (GPT2, "drop"), (BERT, "plain"),
              (BERT, "keypad"), (BERT, "keypad_drop")]


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(gen, b, sq, sk, h, d, fused, dtype=torch.bfloat16):
    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    if fused:       # views of one [b, s, 4, h, d] tensor, as GPT's QKV
        x = rand(b, sq, 4, h, d)
        return x[:, :, 0], x[:, :, 1], x[:, :, 2], x[:, :, 3]
    return rand(b, sq, h, d), rand(b, sk, h, d), rand(b, sk, h, d), \
        rand(b, sq, h, d)


MODES = ("plain", "keypad", "dense", "drop", "keypad_drop", "dense_drop")
OUTS = ("out", "dq", "dk", "dv")
DROP_P = 0.1


def _mode(F, gen, mode, q, k, seed):
    """(bias, dropout_p, seed_arr) of ``mode`` for these q and k."""
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    bias = None
    if mode.startswith("keypad"):
        lens = torch.randint(min(2, sk), sk + 1, (b,), generator=gen,
                             device="cuda")
        keep = torch.arange(sk, device="cuda")[None, :] < lens[:, None]
        bias = F.attn_bias(keep[:, None, None, :].expand(b, 1, sq, sk), q, k)
    elif mode.startswith("dense"):
        m = torch.randn((b, h, sq, sk), generator=gen, device="cuda") * 2
        m[..., 3::11] = float("-inf")
        m[0, 0, -1] = -1e30                  # a row that sees no key
        bias = F.pad_bias(m, b, h, sq, sk)
    p = DROP_P if mode.endswith("drop") else 0.0
    return bias, p, seed if p else None


def _check(S, F, gen, shape, mode, seed, fused=False):
    b, sq, sk, h, d, causal = shape
    q, k, v, do = _inputs(gen, b, sq, sk, h, d, fused)
    errs = S._flash_errors(torch, F, q, k, v, do, d ** -0.5, causal,
                           *_mode(F, gen, mode, q, k, seed), repeat=True)
    failures = errs["failures"]
    if sk == 1:   # dq = dk = 0 exactly: their relative error is 0 / 0
        failures = [f for f in failures if not f.startswith(
            ("dq: relative Frobenius", "dk: relative Frobenius"))]
    return {"shape": list(shape), "mode": mode, "fused": fused,
            "row": {o: errs[o]["row"] for o in ("out", "dq", "dk", "dv")},
            "fro": {o: errs[o]["fro"] for o in ("out", "dq", "dk", "dv")},
            "lse": errs["lse"],
            "failures": failures}


def _check_fp32(S, F, gen, shape, name, seed, fused=False):
    """``flash_fp32_errors`` and a bitwise repeat of dQ and dK/dV in mode
    ``name`` (one of ``MODES``)."""
    b, sq, sk, h, d, causal = shape
    q, k, v, do = _inputs(gen, b, sq, sk, h, d, fused, torch.float32)
    mode = _mode(F, gen, name, q, k, seed)
    errs = S.flash_fp32_errors(torch, F, q, k, v, do, d ** -0.5, causal,
                               *mode)
    fwd = [F.flash_fwd_cuda(q, k, v, d ** -0.5, causal, *mode)
           for _ in range(2)]
    out, lse = fwd[0]
    delta = F.flash_delta(do, out)
    g = [(F.flash_bwd_dq_cuda(q, k, v, do, lse, delta, d ** -0.5, causal,
                              *mode),)
         + F.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, d ** -0.5, causal,
                                *mode) + fwd[i] for i in range(2)]
    failures = list(errs["failures"])
    if sk == 1:   # dq = dk = 0 exactly: their errors are roundings of 0
        failures = [f for f in failures if not f.startswith(("dq:", "dk:"))]
    if not all(torch.equal(x, y) for x, y in zip(*g)):
        failures.append("two launches differ")
    return {"shape": list(shape), "mode": name, "fused": fused,
            "row": {o: errs[o]["kernel"]["row"] for o in OUTS},
            "plain_row": {o: errs[o]["plain"]["row"] for o in OUTS},
            "fro": {o: errs[o]["kernel"]["fro"] for o in OUTS},
            "plain_fro": {o: errs[o]["plain"]["fro"] for o in OUTS},
            "lse": errs["lse"],
            "failures": failures}


def _ms(fn, sets, iters=100, warmup=10):
    for i in range(warmup):
        fn(*sets[i % len(sets)])
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def _times(F, gen, shape, mode, seed, dtype=torch.bfloat16):
    b, sq, sk, h, d, causal = shape
    sets = []
    for _ in range(3):
        q, k, v, do = _inputs(gen, b, sq, sk, h, d, False, dtype)
        bias, p, key = _mode(F, gen, mode, q, k, seed)
        out, lse = F.flash_fwd_cuda(q, k, v, d ** -0.5, causal, bias, p,
                                    key)
        sets.append((q, k, v, do, lse, F.flash_delta(do, out), bias))
    sc = d ** -0.5
    tail = (p, key)
    return {"fwd": _ms(lambda *a: F.flash_fwd_cuda(*a[:3], sc, causal, a[6],
                                                   *tail), sets),
            "dq": _ms(lambda *a: F.flash_bwd_dq_cuda(*a[:6], sc, causal,
                                                     a[6], *tail), sets),
            "dkv": _ms(lambda *a: F.flash_bwd_dkv_cuda(*a[:6], sc, causal,
                                                       a[6], *tail), sets)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--report", default=os.path.join(
        ROOT, "build", "flash_bwd_probe_ptxas.txt"))
    ap.add_argument("--times", action="store_true")
    ap.add_argument("--big", action="store_true")
    ap.add_argument("--fp32", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_bwd_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from paddle_tpu_torch.ops.kernels import build
    from paddle_tpu_torch.ops.kernels import flash_attention as F
    try:
        built = build.build_all(["flash_attention_fwd", "flash_attention_bwd"])
        log = "\n".join(b["log"] for b in built.values())
    except RuntimeError as e:
        log = str(e)
        built = None
    os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
    with open(args.report, "w") as f:
        f.write(log)
    if built is None:
        print(log[-6000:], file=sys.stderr)
        return 1
    S = _smoke()
    gen = torch.Generator(device="cuda").manual_seed(5)
    seed = torch.tensor([7, 11], dtype=torch.int64, device="cuda")
    if args.fp32:
        return _fp32(args, S, F, build.ptxas_report(log), gen, seed)
    report = {name: line for name, line in build.ptxas_report(log).items()
              if "wgmma" in name}
    checks = [_check(S, F, gen, shape, mode, seed)
              for shape in SMALL for mode in MODES]
    checks += [_check(S, F, gen, (2, 300, 300, 3, d, c), mode, seed,
                      fused=True)
               for d in (64, 128) for c in (True, False) for mode in MODES]
    if args.big:
        for shape, modes in BIG:
            checks += [_check(S, F, gen, shape, mode, seed)
                       for mode in modes]
            torch.cuda.empty_cache()
    times = ({f"{shape} {mode}": _times(F, gen, shape, mode, seed)
              for shape, mode in TIMES} if args.times else None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    failed = [c for c in checks if c["failures"]]
    print(json.dumps({"device": smi, "ptxas": report, "checks": checks,
                      "times_ms": times, "failed": len(failed)}), flush=True)
    return 1 if failed else 0


def _fp32(args, S, F, ptxas, gen, seed) -> int:
    report = {n: line for n, line in ptxas.items() if "tf32_kernel" in n}
    spills = [n for n, line in report.items()
              if "0 bytes spill stores" not in line
              or "0 bytes spill loads" not in line]
    checks = [_check_fp32(S, F, gen, shape, mode, seed)
              for shape in FP32_SMALL for mode in MODES]
    checks += [_check_fp32(S, F, gen, (2, 300, 300, 3, 64, c), mode, seed,
                           fused=True)
               for c in (True, False) for mode in MODES]
    if args.big:
        for shape, modes in FP32_BIG:
            checks += [_check_fp32(S, F, gen, shape, mode, seed)
                       for mode in modes]
            torch.cuda.empty_cache()
    times = ({f"{shape} {mode}": _times(F, gen, shape, mode, seed,
                                        torch.float32)
              for shape, mode in FP32_TIMES} if args.times else None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    failed = [c for c in checks if c["failures"]]
    print(json.dumps({"device": smi, "ptxas": report, "spills": spills,
                      "checks": checks, "times_ms": times,
                      "failed": len(failed)}), flush=True)
    return 1 if failed or spills or len(report) != 12 else 0


if __name__ == "__main__":
    sys.exit(main())
