#!/usr/bin/env python3
"""A short first call for the bf16 flash backward's plain mode on a GPU
(``csrc/flash_bwd_wgmma.cuh``: dQ and dK/dV on wgmma, fed by TMA).

    python3 tools/flash_bwd_probe.py [--report FILE] [--times] [--big]

Builds the two flash sources (``ptxas``'s registers and spills per
instantiation, and ``nvcc``'s warnings, go to the file ``--report``
names), then holds the three flash kernels against their plain versions
with ``chip_smoke.py``'s flash check (``_flash_errors``: each row within
2**-7 of its largest magnitude + 1e-3, relative Frobenius error <= 4e-3)
at small shapes that take every branch of the new kernels: d 64 and 128,
causal and not, ragged lengths (s 1, 63, 130, 1000), causal with sq > sk
(rows that see no key) and sq < sk, one q tile of a 128-row block past
the end, and q, k, v, dO as strided views of one fused [b, s, 4, h, d]
tensor; each backward launched twice, bitwise equal. ``--big`` adds
BERT-Base's [32, 512, 12, 64] non-causal and the Llama training shape
[4, 2048, 16, 128] causal. ``--times`` times dQ and dK/dV at those two
shapes (CUDA events, 100 calls cycling three input sets past the L2).
Prints one JSON line.
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
BIG = [(32, 512, 512, 12, 64, False), (4, 2048, 2048, 16, 128, True)]


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(gen, b, sq, sk, h, d, fused):
    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()
    if fused:       # views of one [b, s, 4, h, d] tensor, as GPT's QKV
        x = rand(b, sq, 4, h, d)
        return x[:, :, 0], x[:, :, 1], x[:, :, 2], x[:, :, 3]
    return rand(b, sq, h, d), rand(b, sk, h, d), rand(b, sk, h, d), \
        rand(b, sq, h, d)


def _check(S, F, gen, shape, fused=False):
    b, sq, sk, h, d, causal = shape
    q, k, v, do = _inputs(gen, b, sq, sk, h, d, fused)
    scale = d ** -0.5
    errs = S._flash_errors(torch, F, q, k, v, do, scale, causal)
    out, lse = F.flash_fwd_plain(q.float(), k.float(), v.float(), scale,
                                 causal)
    delta = F.flash_delta(do, out.to(q.dtype))
    runs = [(F.flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale, causal),
             *F.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, scale, causal))
            for _ in range(2)]
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(*runs)):
        errs["failures"].append("a repeat differs")
    return {"shape": list(shape), "fused": fused,
            "row": {o: errs[o]["row"] for o in ("dq", "dk", "dv")},
            "fro": {o: errs[o]["fro"] for o in ("dq", "dk", "dv")},
            "failures": errs["failures"]}


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


def _times(F, gen, shape):
    b, sq, sk, h, d, causal = shape
    sets = []
    for _ in range(3):
        q, k, v, do = _inputs(gen, b, sq, sk, h, d, False)
        out, lse = F.flash_fwd_cuda(q, k, v, d ** -0.5, causal)
        sets.append((q, k, v, do, lse, F.flash_delta(do, out)))
    sc = d ** -0.5
    return {"dq": _ms(lambda *a: F.flash_bwd_dq_cuda(*a, sc, causal), sets),
            "dkv": _ms(lambda *a: F.flash_bwd_dkv_cuda(*a, sc, causal),
                       sets)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--report", default=os.path.join(
        ROOT, "build", "flash_bwd_probe_ptxas.txt"))
    ap.add_argument("--times", action="store_true")
    ap.add_argument("--big", action="store_true")
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
    report = {name: line for name, line in build.ptxas_report(log).items()
              if "wgmma" in name}
    S = _smoke()
    gen = torch.Generator(device="cuda").manual_seed(5)
    checks = [_check(S, F, gen, shape) for shape in SMALL]
    checks += [_check(S, F, gen, (2, 300, 300, 3, d, c), fused=True)
               for d in (64, 128) for c in (True, False)]
    if args.big:
        checks += [_check(S, F, gen, shape) for shape in BIG]
        torch.cuda.empty_cache()
    times = ({f"{shape}": _times(F, gen, shape) for shape in BIG}
             if args.times else None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    failed = [c for c in checks if c["failures"]]
    print(json.dumps({"device": smi, "ptxas": report, "checks": checks,
                      "times_ms": times, "failed": len(failed)}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
