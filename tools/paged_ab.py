#!/usr/bin/env python3
"""Time the paged decode kernel of one source tree, so that two trees (a
parent commit unpacked with ``git archive`` and the working tree) can be
compared on one card in one call, in turns.

    python3 tools/paged_ab.py [--tree PATH] [--rows NAME ...]
                              [--step] [--layers N]

``--tree`` is the root of a checkout holding ``paddle_tpu_torch``
(default: this repository); its paged kernel is built into that tree's
own ``build/kernels``. This repository's ``chip_smoke.py`` makes the
inputs, whatever the tree, so both trees see the same ones. Rows
(``ROWS``): ``bf16_serve`` and ``int8_serve``, the smoke's
``paged_attention`` and ``paged_attention_int8`` shapes (b 8, h 32, kvh
8, d 128, page 16, 32-page tables; ``PAGED_LENS`` and ``SERVE_CONTEXTS``);
``bf16_long`` and ``int8_long``, the long context (``LONG_CONTEXTS``:
8 slots of 4096 positions, 256-page tables); ``bf16_short`` and
``int8_short``, one slot of 16 positions (seq_lens 15) over 32-page
tables. Each row is timed over 100 calls cycling 16 argument sets (24 for
``int8_serve``, as the smoke), after 10 warm-up calls: CUDA events (what
a caller waits, the host's enqueue included) and the summed device time
of a ``torch.profiler`` trace of 100 calls; the card's SM clock,
temperature and power draw are read before and after each row.
``--step`` then serves at Llama-3-8B widths (32 layers; ``--layers``
cuts the depth only): 8 requests whose prompts are ``SERVE_CONTEXTS``
tokens long, prefilled, then 4 decode steps under ``torch.profiler``
(device ms a step, idle share, host wall a step, and the paged kernel's
device ms and share), bf16, then the same after
``quantize_for_serving(inplace=True)`` over the int8 pool. Prints one
JSON line: the tree, the card, the rows and the steps.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = ("bf16_serve", "int8_serve", "bf16_long", "int8_long", "bf16_short",
        "int8_short")
SHORT = (15,)          # one slot of 16 positions
DECODE_STEPS = 4


def _gpu_state() -> str:
    """The card's SM clock (MHz), temperature (C) and power draw (W) now,
    as ``nvidia-smi`` reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,temperature.gpu,power.draw",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def _harness():
    """This repository's ``chip_smoke.py`` (whatever tree ``main``
    imported the package from)."""
    spec = importlib.util.spec_from_file_location(
        "repo_smoke", os.path.join(HERE, "chip_smoke.py"))
    S = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(S)
    return S


def _sets(S, QZ, name):
    """The argument sets of row ``name`` and the call that takes them."""
    gen = torch.Generator(device="cuda").manual_seed(ROWS.index(name) + 1)
    bf16, kind = name.split("_")[0] == "bf16", name.split("_")[1]
    lens, M = {"serve": (S.PAGED_LENS if bf16 else S.SERVE_CONTEXTS, 32),
               "long": (S.LONG_CONTEXTS, S.LONG_PAGES),
               "short": (SHORT, 32)}[kind]
    n_sets = 24 if name == "int8_serve" else 16
    if bf16:
        return S.paged_inputs(torch, gen, lens, M=M, n_sets=n_sets), False
    return S.paged_int8_inputs(torch, QZ, gen, n_sets=n_sets,
                               contexts=lens, M=M), True


def _rows(S, K, QZ, names) -> dict:
    out = {}
    for name in names:
        sets, int8 = _sets(S, QZ, name)
        fn = ((lambda *a: S._paged_int8(K, *a)) if int8
              else K.paged_attention_cuda)
        before = _gpu_state()
        ms = S._time_ms(torch, fn, sets)
        device_ms = S._device_ms(torch, fn, sets, iters=100)
        out[name] = {"ms": ms, "device_ms": device_ms,
                     "gpu": {"before": before, "after": _gpu_state()}}
        del sets
        torch.cuda.empty_cache()
    return out


def _decode_steps(S, K, eng) -> dict:
    """Prefill every request, then ``DECODE_STEPS`` decode steps under
    the profiler."""
    while eng.scheduler.waiting or any(
            r.prefilling or not r.tokens
            for r in eng.scheduler.running.values()):
        eng.step()
    before = dict(eng.step_counts)
    K.reset_launch_counts()
    prof = S._profile_steps(torch, eng.step, DECODE_STEPS, top=None)
    ran = {k: eng.step_counts[k] - before[k] for k in before}
    if ran != {"decode": DECODE_STEPS, "mixed": 0}:
        raise AssertionError(f"profiled steps were {ran}")
    ranked = prof.pop("all_kernels_ms")
    prof.pop("kernel_sequence")
    paged = sum(ms for k, ms in ranked if "paged_decode_kernel" in k)
    prof["paged_device_ms"] = paged
    prof["paged_share"] = paged / prof["device_ms"] if prof[
        "device_ms"] else None
    prof["paged_kernels"] = sorted({k for k, _ in ranked
                                    if "paged_decode_kernel" in k})
    prof["launches"] = {k: v for k, v in K.launch_counts().items() if v}
    prof["contexts_after"] = sorted(len(r.prompt) + len(r.tokens)
                                    for r in eng.scheduler.running.values())
    return prof


def _step(S, K, QZ, layers) -> dict:
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_3_8b
    from paddle_tpu_torch.serving import ServingEngine
    cfg = llama_3_8b(dtype="bfloat16")
    if layers is not None:
        cfg.num_hidden_layers = layers
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", seed=S.SEED)
    model.eval()
    torch.cuda.synchronize()
    out = {"layers": cfg.num_hidden_layers,
           "init_s": time.perf_counter() - t0}
    rng = np.random.default_rng(S.SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in S.SERVE_CONTEXTS]
    for kv_quant in (False, True):
        if kv_quant:
            QZ.quantize_for_serving(model, inplace=True)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        eng = ServingEngine(model, num_pages=256, page_size=16, max_slots=8,
                            prefill_chunk=64, max_pages_per_slot=32,
                            kv_quant=kv_quant)
        for i, p in enumerate(prompts):
            eng.add_request(p, 16, rid=f"r{i}")
        with torch.no_grad():
            out["int8" if kv_quant else "bf16"] = _decode_steps(S, K, eng)
        del eng
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--rows", nargs="*", choices=ROWS,
                    help="the rows to time, in this order (default: all; "
                         "none with an empty list)")
    ap.add_argument("--step", action="store_true")
    ap.add_argument("--layers", type=int, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("paged_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.tree))
    from paddle_tpu_torch import quantization as QZ
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.ops.kernels import build
    if not os.path.abspath(K.__file__).startswith(os.path.abspath(args.tree)):
        raise SystemExit(f"paged_ab: paddle_tpu_torch came from "
                         f"{K.__file__}, not from {args.tree}")
    built = build.build_all(["paged_attention", "rms_norm"])
    S = _harness()
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = _rows(S, K, QZ, ROWS if args.rows is None else args.rows)
    step = _step(S, K, QZ, args.layers) if args.step else None
    print(json.dumps({
        "tree": args.tree, "device": S._nvidia_smi(), "rows": rows,
        "step": step, "ptxas": [
            ln for ln in built["paged_attention"]["log"].splitlines()
            if "registers" in ln or "spill" in ln]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
