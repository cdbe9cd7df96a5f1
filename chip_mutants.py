#!/usr/bin/env python3
"""Plant known faults in the flash attention kernels and show which of
``chip_smoke.py``'s checks catch each one (a mutation check, on one GPU).

    python3 chip_mutants.py [--only NAME ...]

For the unchanged kernels (``control``) and for each fault below, the
script copies ``paddle_tpu_torch/`` and ``chip_smoke.py`` into a fresh
temporary directory, edits one kernel source there (the repository is
never touched), and runs, in a child process on that copy:

- the flash kernel check of ``chip_smoke.py`` (``_flash_errors``) at
  the training path's shape, q/k/v [4, 2048, 16, 128] bf16 causal;
- train parity (``train_parity_run``): three training steps of the
  ``bench.py::_llama_flagship`` configuration through the kernels and
  inside ``plain_reference()``, from one state: the one the smoke's
  train phase leaves, 10 steps through the kernels on the fixed batch
  (from a fresh optimizer, Adam's first steps move every weight by
  ~lr whatever the size of its gradient, so the master weights of two
  runs part by up to 2 lr a step wherever a tiny gradient changes
  sign).

It prints one JSON line per run and then a summary line. It exits 0
when the control passes both checks and every fault fails the kernel
check; which train-parity limits each fault breaks is reported, not
required (a fault of random rounding can stay inside end-to-end
limits that a kernel-level check resolves).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

BWD, FWD = "flash_attention_bwd.cu", "flash_attention_fwd.cu"
FP8 = ('#include "flash_common.cuh"',
       '#include "flash_common.cuh"\n#include <cuda_fp8.h>')

# name -> (what it does, [(source, old text, new text), ...])
MUTANTS = {
    "fwd_rows_from_512_x1.07": (
        "forward: output rows from 512 on scaled by 1.07 (a systematic 7% "
        "error where causal rows are small)",
        [(FWD, "const float l_safe = l == 0.f ? 1.f : l;",
          "const float l_safe = (l == 0.f ? 1.f : l) / "
          "(row[r] >= 512 ? 1.07f : 1.f);")]),
    "fwd_p_fp8": (
        "forward: P rounded to fp8 e4m3 (not bf16) for the P V product",
        [(FWD, *FP8),
         (FWD, "        s[nt][i] = p;\n",
          "        s[nt][i] = float(__nv_fp8_e4m3(p));\n")]),
    "dq_drops_last_k_tile": (
        "dQ: the loop over k tiles stops one tile early (the diagonal "
        "tile, causal)",
        [(BWD, "for (int jt = 0; jt < n_tiles; ++jt) {",
          "for (int jt = 0; jt < n_tiles - 1; ++jt) {")]),
    "dkv_skips_first_q_tile": (
        "dK/dV: the loop over q tiles starts one tile past the diagonal",
        [(BWD, "const int i0 = first / BQ,",
          "const int i0 = first / BQ + 1,")]),
    "dkv_p_fp8": (
        "dK/dV: P rounded to fp8 e4m3 (not bf16) for dV += P^T dO",
        [(BWD, *FP8),
         (BWD, "        s[nt][i] = p;                                   // P^T",
          "        s[nt][i] = float(__nv_fp8_e4m3(p));             // P^T")]),
}

HERE = os.path.dirname(os.path.abspath(__file__))


def _copy(name: str) -> str:
    """A copy of the package and chip_smoke.py with mutant ``name``."""
    root = tempfile.mkdtemp(prefix=f"mutant-{name}-")
    shutil.copytree(os.path.join(HERE, "paddle_tpu_torch"),
                    os.path.join(root, "paddle_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for f in ("chip_smoke.py", "chip_mutants.py"):
        shutil.copy(os.path.join(HERE, f), root)
    for source, old, new in MUTANTS.get(name, ("", []))[1]:
        path = os.path.join(root, "paddle_tpu_torch", "csrc", source)
        with open(path) as fh:
            text = fh.read()
        if text.count(old) != 1:
            raise RuntimeError(f"mutant {name}: {old!r} occurs "
                               f"{text.count(old)} times in {source}")
        with open(path, "w") as fh:
            fh.write(text.replace(old, new))
    return root


def child(name: str) -> dict:
    """Both checks on the tree this file sits in (a mutated copy)."""
    import numpy as np
    import torch
    sys.path.insert(0, HERE)
    import chip_smoke as S
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.ops.kernels import build
    from paddle_tpu_torch.ops.kernels import flash_attention as F
    from paddle_tpu_torch.optimizer import AdamW
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all(["rms_norm", "flash_attention_fwd",
                     "flash_attention_bwd"])
    b, s, h, d = 4, S.TRAIN_SEQ, 16, 128
    gen = torch.Generator(device="cuda").manual_seed(S.SEED + 4)
    q, k, v, do = (torch.randn((b, s, h, d), generator=gen,
                               device="cuda").bfloat16() for _ in range(4))
    flash = S._flash_errors(torch, F, q, k, v, do, d ** -0.5, True)
    del q, k, v, do
    torch.cuda.empty_cache()
    cfg = S.flagship_config(LlamaConfig, S.TRAIN_SEQ)
    model = LlamaForCausalLM(cfg, device="cuda", seed=S.SEED)
    batch = torch.tensor(np.random.default_rng(S.SEED).integers(
        0, cfg.vocab_size, (S.TRAIN_BATCH, S.TRAIN_SEQ)), dtype=torch.int32,
        device="cuda")
    opt = AdamW(learning_rate=S.TRAIN_LR, parameters=model)
    step = TrainStep(model, opt, lambda logits, y: model.loss(logits, y))
    for _ in range(S.TRAIN_STEPS):
        step(batch, batch)
    parity = S.train_parity_run(torch, K, model, opt, TrainStep, batch)
    grads = parity.pop("grad_rel_l2")
    parity["top_grad_rel_l2"] = sorted(grads.items(),
                                       key=lambda kv: -kv[1])[:5]
    return {"mutant": name,
            "fault": MUTANTS.get(name, ("none (the kernels as they are)",))[0],
            "flash": flash, "train_parity": parity,
            "caught_by_kernel_check": bool(flash["failures"]),
            "caught_by_train_parity": bool(parity["failures"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="*", help="run these mutants only")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(child(args.child)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("chip_mutants: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    names = ["control"] + (args.only or list(MUTANTS))
    results = {}
    for name in names:
        root = _copy(name)
        try:
            proc = subprocess.run(
                [sys.executable, os.path.join(root, "chip_mutants.py"),
                 "--child", name], cwd=root, capture_output=True, text=True,
                timeout=900)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            results[name] = {"mutant": name, "error": proc.returncode}
        else:
            results[name] = json.loads(lines[-1])
        print(json.dumps(results[name]), flush=True)
    summary = {n: {"kernel_check": r.get("caught_by_kernel_check"),
                   "train_parity": r.get("caught_by_train_parity"),
                   "parity_failures": r.get("train_parity", {})
                   .get("failures")} for n, r in results.items()}
    print(json.dumps({"caught": summary}), flush=True)
    ok = (summary["control"]["kernel_check"] is False
          and summary["control"]["train_parity"] is False
          and all(summary[n]["kernel_check"] is True for n in names[1:]))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
