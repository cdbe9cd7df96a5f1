#!/usr/bin/env python3
"""A short first call for the grouped-GEMM MoE kernels on a GPU: build
``moe_grouped_gemm.cu`` and ``moe_routing.cu`` (``ptxas``'s registers and
spills per instantiation go to the file ``--report`` names), then hold
the fp32 forward, dX and dW against the plain versions in fp64
(``chip_smoke.moe_fp32_errors``: the flash fp32 rule per output, a
bitwise repeat) at small shapes, gated silu and ungated relu, the
routing kernel against its plain version (``chip_smoke.routing_errors``)
at ``ROUTES``' [T, E], and the
bf16 mode against its plain version (``chip_smoke.moe_errors``) at
``BF16``'s shapes: H past a 64 tile, D not a multiple of 128, the
training shape, and ``chip_smoke.MOE_EDGES`` (cpad 40 with ungated relu;
one expert holding every token, so whole 128-slot blocks are empty).

    python3 tools/moe_fp32_probe.py [--report FILE] [--full]
    python3 tools/moe_fp32_probe.py --times [--train] [--tree PATH]

``--full`` then runs ``chip_smoke.py``'s ``moe_fp32_kernels`` and
``moe_kernels`` phases (the slice's shapes, with their times).
``--times`` runs the timings alone: the forward, dX and dW at the
Qwen2-MoE training shapes (T 8192, E 16, D 1024, cpad 1280; bf16 at H
704 and, where the tree's kernels take fp32, fp32 at H 512), and the
routing kernel at [8192, 16] and [65536, 16], mean ms of 100 calls
between CUDA events and each pass's device time by kernel name (a
profiler trace of 20 calls), with the kernels of the checkout
``--tree`` names (built into its own ``build/kernels``), so that two
trees can be compared on one card in one call, in turns. Prints one
JSON line: the tree, the card, the times. ``--train`` then runs
``chip_smoke.py``'s ``train_moe`` and ``train_moe_profile`` phases (10
steps of the ``qwen2_moe_fused`` configuration, then one profiled step)
on that tree's package and kernels.
"""

import argparse
import importlib.util
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SMALL = [  # (T, E, D, H, act)
    (1024, 4, 128, 64, "silu"), (1024, 4, 128, 96, "relu"),
    (2048, 8, 256, 512, "silu"), (1024, 16, 128, 32, "silu"),
    # H 160 and D 192: the forward's last 128-column block half empty in
    # both passes
    (1024, 4, 192, 160, "silu")]
ROUTES = [(8192, 16), (65536, 16), (2048, 128), (3072, 6)]
BF16 = [(1024, 4, 128, 96), (2048, 16, 192, 32), (8192, 16, 1024, 704)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--report", default=os.path.join(
        ROOT, "build", "moe_fp32_probe_ptxas.txt"))
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--times", action="store_true")
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--tree", default=ROOT)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("moe_fp32_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.tree))
    # this checkout's chip_smoke.py, whatever tree the kernels come from
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    S = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(S)
    if args.times:
        rc = _times(S, args.tree, args.report)
        return rc or (_train(S) if args.train else 0)
    from paddle_tpu_torch.ops.kernels import build
    from paddle_tpu_torch.ops.kernels import moe_grouped_gemm as GG
    from paddle_tpu_torch.ops.kernels import moe_routing as MR
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    out = build.build_all(["moe_grouped_gemm", "moe_routing"])
    print("build s", time.time() - t0, flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                exist_ok=True)
    with open(args.report, "w") as fh:
        for name, b in out.items():
            for fn, line in build.ptxas_report(b["log"]).items():
                fh.write(f"{name}: {fn}: {line}\n")
            fh.writelines(f"{name}: {line}\n" for line in
                          b["log"].splitlines()
                          if "arning" in line or "Performance" in line)
    failures = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for T, E, D, H, act in SMALL:
        inp = S.moe_inputs(torch, GG, MR, gen, T=T, E=E, D=D, H=H,
                           dtype="float32")
        res = S.moe_fp32_errors(
            torch, GG, inp["x"], inp["row_id"], inp["gate_w"], inp["wi"],
            inp["wg"] if act == "silu" else None, inp["wo"], inp["g"], act)
        failures += res["failures"]
        print(json.dumps({"fp32": [T, E, D, H, act], **res}), flush=True)
    for T, E in ROUTES:
        logits = (torch.randn((T, E), generator=gen, device="cuda") * 1.5
                  + torch.linspace(0.0, 1.5, E, device="cuda"))
        u = torch.rand((T,), generator=gen, device="cuda")
        res = S.routing_errors(torch, MR, logits, u)
        failures += [f"routing {[T, E]} {f}" for f in res["failures"]]
        print(json.dumps({"routing": [T, E], **res}), flush=True)
    for T, E, D, H in BF16:
        inp = S.moe_inputs(torch, GG, MR, gen, T=T, E=E, D=D, H=H)
        res = S.moe_errors(torch, GG, inp["x"], inp["row_id"],
                           inp["gate_w"], inp["wi"], inp["wg"], inp["wo"],
                           inp["g"])
        failures += [f"bf16 {[T, E, D, H]} {f}" for f in res["failures"]]
        print(json.dumps({"bf16": [T, E, D, H, "silu"], **res}), flush=True)
    for res in S.moe_edge_errors(torch, GG, MR, gen):
        failures += [f"bf16 {res['case']} {f}" for f in res["failures"]]
        print(json.dumps({"bf16_edge": res}), flush=True)
    if failures:
        print(json.dumps({"failures": failures}), flush=True)
    if args.full:
        S.phase_moe_fp32_kernels(torch, MR, GG)
        S.phase_moe_kernels(torch, MR, GG)
    return 1 if failures else 0


def _times(S, tree, report):
    from paddle_tpu_torch.ops.kernels import build
    from paddle_tpu_torch.ops.kernels import moe_grouped_gemm as GG
    from paddle_tpu_torch.ops.kernels import moe_routing as MR
    if not os.path.abspath(GG.__file__).startswith(os.path.abspath(tree)):
        raise SystemExit(f"moe_fp32_probe: paddle_tpu_torch came from "
                         f"{GG.__file__}, not from {tree}")
    built = build.build_all(["moe_grouped_gemm", "moe_routing"])
    if built["moe_grouped_gemm"]["built"]:
        os.makedirs(os.path.dirname(os.path.abspath(report)), exist_ok=True)
        with open(report, "a") as fh:
            fh.write(f"--- {tree}\n{built['moe_grouped_gemm']['log']}\n")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(S.SEED + 5)
    ms, passes = {}, {}
    for dtype, H in (("bfloat16", 704), ("float32", S.MOE_FP32_H)):
        inp = S.moe_inputs(torch, GG, MR, gen, H=H, dtype=dtype)
        args = (inp["x"], inp["row_id"], inp["gate_w"], inp["wi"],
                inp["wg"], inp["wo"])
        if GG.kernel_gate(*args, "silu") is not None:
            continue            # a tree whose kernels take bf16 only
        _, _, inter = GG.moe_dx_cuda(*args, inp["g"], "silu")
        calls = {"fwd": (GG.moe_fwd_cuda, args + ("silu",)),
                 "dx": (GG.moe_dx_cuda, args + (inp["g"], "silu")),
                 "dw": (GG.moe_dw_cuda, (inp["x"], inp["row_id"],
                                         inp["gate_w"], inp["g"], inter))}
        ms[dtype] = {k: S._time_ms(torch, fn, [a])
                     for k, (fn, a) in calls.items()}
        passes[dtype] = {
            k: {S._short_kernel_name(n): t for n, t in S._profile_steps(
                torch, lambda: fn(*a), 20, top=None)["all_kernels_ms"]}
            for k, (fn, a) in calls.items()}
        del inp, args, inter
        torch.cuda.empty_cache()
    for T, E in ((8192, 16), (65536, 16)):
        logits = (torch.randn((T, E), generator=gen, device="cuda") * 1.5
                  + torch.linspace(0.0, 1.5, E, device="cuda"))
        u = torch.rand((T,), generator=gen, device="cuda")
        name = f"routing_{T}x{E}"
        ms[name] = S._time_ms(torch, MR.moe_routing_cuda, [(logits, u, True)])
        passes[name] = {S._short_kernel_name(n): t for n, t in
                        S._profile_steps(
                            torch, lambda: MR.moe_routing_cuda(logits, u, True),
                            20, top=None)["all_kernels_ms"]}
    print(json.dumps({"tree": tree, "device": S._nvidia_smi(), "ms": ms,
                      "device_ms_by_kernel": passes}), flush=True)
    return 0


def _train(S):
    import numpy as np
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import Qwen2MoeConfig, Qwen2MoeForCausalLM
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.ops.kernels import build
    from paddle_tpu_torch.optimizer import AdamW
    build.build_all()
    cfg = S.moe_config(Qwen2MoeConfig, S.MOE_SEQ)
    model = Qwen2MoeForCausalLM(cfg, device="cuda", seed=S.SEED)
    batch = torch.tensor(np.random.default_rng(S.SEED).integers(
        0, cfg.vocab_size, (S.MOE_BATCH, S.MOE_SEQ)), dtype=torch.int32,
        device="cuda")
    _, opt = S.phase_train_moe(torch, K, model, TrainStep, AdamW, batch,
                               S._nvidia_smi())
    S.phase_train_moe_profile(torch, model, opt, TrainStep, batch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
