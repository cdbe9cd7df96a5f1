#!/usr/bin/env python3
"""Plant known faults in the flash attention, MoE and int8 paged
kernels and show which of ``chip_smoke.py``'s checks catch each one (a
mutation check, on one GPU).

    python3 chip_mutants.py [--only NAME ...]

For the unchanged kernels (``control``) and for each fault below, the
script copies ``paddle_tpu_torch/`` and ``chip_smoke.py`` into a fresh
temporary directory, edits one kernel source there (the repository is
never touched), and runs, in a child process on that copy, the checks
of the fault's kind (the control runs every kind of the faults chosen):

- flash: the flash kernel check of ``chip_smoke.py`` (``_flash_errors``)
  at the training path's shape, q/k/v [4, 2048, 16, 128] bf16 causal,
  and train parity (``train_parity_run``): three training steps of the
  ``bench.py::_llama_flagship`` configuration through the kernels and
  inside ``plain_reference()``, from one state: the one the smoke's
  train phase leaves, 10 steps through the kernels on the fixed batch
  (from a fresh optimizer, Adam's first steps move every weight by
  ~lr whatever the size of its gradient, so the master weights of two
  runs part by up to 2 lr a step wherever a tiny gradient changes
  sign);
- moe: the MoE kernel checks (``routing_errors``, ``moe_errors``) at the
  Qwen2-MoE training shapes, and the MoE train parity of
  ``phase_train_moe_parity`` (``MOE_PARITY``) after 10 steps of the
  ``qwen2_moe_fused`` configuration;
- int8: the int8 paged kernel check (``paged_int8_errors``) at the
  serving shapes, and slice parity over the int8 pool
  (``parity_run(kv_quant=True)``): one decode step through the kernels
  and inside ``plain_reference()`` on a model of Llama-3-8B widths with
  int8 weights, cut to ``INT8_LAYERS`` layers.

It prints one JSON line per run and then a summary line. It exits 0
when the control passes both checks and every fault fails the kernel
check; which parity limits each fault breaks is reported, not required
(a fault of random rounding can stay inside end-to-end limits that a
kernel-level check resolves).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

BWD, FWD = "flash_attention_bwd.cu", "flash_attention_fwd.cu"
ROUTE, GG = "moe_routing.cu", "moe_grouped_gemm.cu"
PAGED = "paged_attention.cu"
INT8_LAYERS = 4
FP8 = ('#include "flash_common.cuh"',
       '#include "flash_common.cuh"\n#include <cuda_fp8.h>')

# name -> (what it does, [(source, old text, new text), ...][, kind]);
# the kind is "flash" unless given
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
    "moe_scatter_keeps_one_copy": (
        "grouped forward: the scatter stores instead of adding, so a token "
        "row keeps one of its two experts' contributions",
        [(GG, "      atomicAdd(out + (int64_t)rows[r] * d.D + dt * kT "
              "+ acc_col(lane, n, i),\n                acc[n][i] * gw[r]);",
          "      out[(int64_t)rows[r] * d.D + dt * kT + acc_col(lane, n, i)]"
          " =\n                acc[n][i] * gw[r];")], "moe"),
    "moe_dx_drops_gate_branch": (
        "grouped dX: dx takes dh1 W_in^T only, without dhg W_gate^T",
        [(GG, "    if (d.gated) {\n      load_dense(sa, dhg + e * CH,",
          "    if (false) {\n      load_dense(sa, dhg + e * CH,")], "moe"),
    "moe_dw_out_without_gate_weight": (
        "grouped dW: dW_out = h^T g, the gate weight left out of dy",
        [(GG, "      load_dy(sb1, g, d.D, rows, gw, dt * kT);",
          "      for (int i = threadIdx.x; i < kT; i += kThreads) "
          "gw[i] = rows[i] >= 0 ? 1.f : 0.f;\n      __syncthreads();\n"
          "      load_dy(sb1, g, d.D, rows, gw, dt * kT);")], "moe"),
    "moe_dw_skips_last_block": (
        "grouped dW: the loop over an expert's slots skips its last "
        "64-slot block",
        [(GG, "for (int sb = 0; sb < n_sb; ++sb) {",
          "for (int sb = 0; sb < n_sb - 1; ++sb) {")], "moe"),
    "moe_routing_top2_not_after_top1": (
        "routing: count1 reported as 0, so the top-2 claims take slots "
        "from position 0, on top of the top-1 claims instead of after them",
        [(ROUTE, "count1_out[tid] = (float)run1[tid];",
          "count1_out[tid] = 0.f;")], "moe"),
    "int8_v_scale_dropped": (
        "int8 paged: V codes read as if their row scale were 1",
        [(PAGED, "vv[e] *= sv;", "vv[e] *= 1.f;")], "int8"),
    "int8_k_scale_wrong_row": (
        "int8 paged: each K row takes the scale of the next row of its page",
        [(PAGED, "k_scale[(page * ps + t % ps) * kvh + n]",
          "k_scale[(page * ps + (t + 1) % ps) * kvh + n]")], "int8"),
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


def _kind(name: str) -> str:
    entry = MUTANTS.get(name, ())
    return entry[2] if len(entry) > 2 else "flash"


def _flash_checks(torch, S, K, TrainStep, AdamW) -> tuple:
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops.kernels import flash_attention as F
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
    del model, opt, step
    torch.cuda.empty_cache()
    return flash, parity


def _moe_checks(torch, S, K, TrainStep, AdamW) -> tuple:
    from paddle_tpu_torch.models import Qwen2MoeConfig, Qwen2MoeForCausalLM
    from paddle_tpu_torch.ops.kernels import moe_grouped_gemm as GG
    from paddle_tpu_torch.ops.kernels import moe_routing as MR
    gen = torch.Generator(device="cuda").manual_seed(S.SEED + 5)
    inp = S.moe_inputs(torch, GG, MR, gen)
    route = S.routing_errors(torch, MR, inp["logits"], inp["u"])
    grouped = S.moe_errors(torch, GG, inp["x"], inp["row_id"],
                           inp["gate_w"], inp["wi"], inp["wg"], inp["wo"],
                           inp["g"])
    check = {"routing": route, "grouped": grouped,
             "failures": route["failures"] + grouped["failures"]}
    del inp
    torch.cuda.empty_cache()
    cfg = S.moe_config(Qwen2MoeConfig, S.MOE_SEQ)
    model = Qwen2MoeForCausalLM(cfg, device="cuda", seed=S.SEED)
    batch = torch.tensor(np.random.default_rng(S.SEED).integers(
        0, cfg.vocab_size, (S.MOE_BATCH, S.MOE_SEQ)), dtype=torch.int32,
        device="cuda")
    opt = AdamW(learning_rate=S.TRAIN_LR, parameters=model)
    step = TrainStep(model, opt, lambda logits, y: model.loss(logits, y))
    for _ in range(S.MOE_STEPS):
        step(batch, batch)
    parity = S.train_parity_run(
        torch, K, model, opt, TrainStep, batch,
        kernels=S.FLASH_KERNELS + S.MOE_KERNELS, limits=S.MOE_PARITY,
        reseed=lambda: model.generator.manual_seed(S.SEED + 6),
        probes=S.moe_probes(model), probe_limits=S.MOE_PROBE_LIMITS)
    return check, parity


def _int8_checks(torch, S, K, TrainStep, AdamW) -> tuple:
    from paddle_tpu_torch import quantization as QZ
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_3_8b
    from paddle_tpu_torch.serving import ServingEngine
    gen = torch.Generator(device="cuda").manual_seed(S.SEED + 7)
    check = S.paged_int8_errors(torch, K,
                                S.paged_int8_inputs(torch, QZ, gen, 1)[0])
    cfg = llama_3_8b(dtype="bfloat16")
    cfg.num_hidden_layers = INT8_LAYERS
    model = QZ.quantize_for_serving(
        LlamaForCausalLM(cfg, device="cuda", seed=S.SEED), inplace=True)
    parity = S.parity_run(torch, np, model, ServingEngine, K, kv_quant=True)
    del model
    torch.cuda.empty_cache()
    return check, parity


def child(name: str, kinds=None) -> dict:
    """The checks of the mutant's kind on the tree this file sits in (a
    mutated copy); the control runs ``kinds``."""
    import torch
    sys.path.insert(0, HERE)
    import chip_smoke as S
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.ops.kernels import build
    from paddle_tpu_torch.optimizer import AdamW
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    kinds = kinds if name == "control" else (_kind(name),)
    out = {"mutant": name, "fault": MUTANTS.get(
        name, ("none (the kernels as they are)",))[0]}
    caught_k, caught_p = False, False
    checks = {"flash": _flash_checks, "moe": _moe_checks,
              "int8": _int8_checks}
    for kind in kinds:
        check, parity = checks[kind](torch, S, K, TrainStep, AdamW)
        grads = parity.pop("grad_rel_l2", None)
        if grads is not None:
            parity["top_grad_rel_l2"] = sorted(grads.items(),
                                               key=lambda kv: -kv[1])[:5]
        out[kind] = check
        out[kind + ("_slice_parity" if kind == "int8"
                    else "_train_parity")] = parity
        caught_k |= bool(check["failures"])
        caught_p |= bool(parity["failures"])
    out["caught_by_kernel_check"] = caught_k
    out["caught_by_parity"] = caught_p
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="*", help="run these mutants only")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--kinds", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        kinds = tuple(args.kinds.split(",")) if args.kinds else None
        print(json.dumps(child(args.child, kinds)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("chip_mutants: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    names = ["control"] + (args.only or list(MUTANTS))
    kinds = sorted({_kind(n) for n in names[1:]})
    results = {}
    for name in names:
        root = _copy(name)
        try:
            proc = subprocess.run(
                [sys.executable, os.path.join(root, "chip_mutants.py"),
                 "--child", name, "--kinds", ",".join(kinds)], cwd=root,
                capture_output=True, text=True, timeout=1200)
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
                   "parity": r.get("caught_by_parity"),
                   "parity_failures": {
                       k: v.get("failures") for k, v in r.items()
                       if isinstance(v, dict) and k.endswith("_parity")}}
               for n, r in results.items()}
    print(json.dumps({"caught": summary}), flush=True)
    ok = (summary["control"]["kernel_check"] is False
          and summary["control"]["parity"] is False
          and all(summary[n]["kernel_check"] is True for n in names[1:]))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
