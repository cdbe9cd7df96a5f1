#!/usr/bin/env python3
"""Time the no-segment modes of the flash kernels of one source tree, so
that two trees (a parent commit unpacked with ``git archive`` and the
working tree) can be compared on one card in one call, in turns.

    python3 tools/flash_ab.py [--tree PATH] [--rows NAME ...] [--train]
                              [--steps [NAME ...]]

``--tree`` is the root of a checkout holding ``paddle_tpu_torch`` (default:
this repository); its kernels are built into that tree's own
``build/kernels``. Modes and shapes: bf16 causal at the Llama training
shape [4, 2048, 16, 128]; bf16 non-causal without a bias at BERT-Base's
[32, 512, 12, 64] (``train_bert``'s path); fp32 and bf16 causal at GPT-2
small's [8, 1024, 12, 64] (bf16: the dropout rows' no-dropout twin); bf16
and fp32 with a key-padding bias (seeded lengths
128-512) at BERT-Base's shape non-causal; the dropout mode (p 0.1, one
key) in bf16 and fp32 at GPT-2's shape, and in bf16 and fp32 with the
bias at BERT's; the segment mode on ``bench.py::bench_llama``'s first packed
host step, bf16 [1, 8760, 16, 128] and fp32 [1, 8760, 12, 64] causal, 8
documents. Each kernel's time is the mean of 100 launches between CUDA
events, cycling three input sets (past the 50 MB L2), after 10 warm-up
launches; beside each no-segment row's forward, ``sdpa_fwd`` times
``scaled_dot_product_attention`` on the same inputs in the row's mode
(its dtype, causal flag, mask as an additive fp32 bias and dropout p:
the library yardstick). ``--rows`` times the rows named, in that order
(each row's inputs are the same whatever runs before it), and the
card's SM clock,
temperature and power draw are read before and after each row (``gpu``
in the output), so that a row slower for the card's state shows it.
``--train`` then runs ``chip_smoke.py``'s Llama ``train`` phase
(``bench.py::_llama_flagship``, 10 steps) and one profiled step
(``train_profile``: device time by category, idle share) on that tree's
package, with this repository's ``chip_smoke.py`` as the harness.
``--steps`` runs, the same way, the steps that the bias and dropout
modes carry (those named, in ``STEPS``' order; all without a name):
``train_bert_padded`` (BERT-Base bf16 on the padded batch, 10 steps: the
bf16 bias mode), the two arms of ``train_dropout_bf16`` at dropout 0.1,
``gpt2_bf16`` (GPT-2 small, 10 steps: the bf16 dropout mode) and
``bert_bf16`` (BERT-Base on the padded batch, 10 steps: the bf16 bias +
dropout mode), ``train_gpt2`` (GPT-2 small at its defaults, fp32 at
dropout 0.1, 10 steps: the fp32 dropout mode) and the defaults arm of
``train_bert_defaults`` (BERT-Base at its own defaults, fp32 at dropout
0.1, on the padded batch, 10 steps: the fp32 bias + dropout mode),
``train_bert_nodrop`` (the same at dropout 0, ``train_bert_defaults``'
no-dropout arm: the fp32 bias mode), ``train_moe_fp32``
(``chip_smoke.moe_fp32_config``, 10 steps: the fp32 plain mode) and
``train_moe`` (``chip_smoke.moe_config``, bf16, 10 steps), each
with its peak memory over the 10 steps and one profiled step (device
time by category, idle share, the flash forward and backward kernels
that ran, and the grouped-GEMM kernels by pass and the routing kernel
where the step has them). Prints one JSON line: the tree,
the card, the times in ms, the steps' figures, and, when this run built
the kernels, ``ptxas``'s registers and spills per instantiation.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKED = (1762, 1490, 825, 1537, 558, 463, 297, 1828)   # bench_llama's
BERT, GPT2 = (32, 512, 12, 64), (8, 1024, 12, 64)
# name: (shape, dtype, causal, key-padding bias, dropout p); a row's inputs
# come from a generator seeded with its place here, whatever rows run
ROWS = {
    "bf16_llama": ((4, 2048, 16, 128), torch.bfloat16, True, False, 0.0),
    "bf16_bert": (BERT, torch.bfloat16, False, False, 0.0),
    "fp32_gpt2": (GPT2, torch.float32, True, False, 0.0),
    "bf16_gpt2": (GPT2, torch.bfloat16, True, False, 0.0),
    "bf16_bert_bias": (BERT, torch.bfloat16, False, True, 0.0),
    "fp32_bert_bias": (BERT, torch.float32, False, True, 0.0),
    "bf16_gpt2_drop": (GPT2, torch.bfloat16, True, False, 0.1),
    "fp32_gpt2_drop": (GPT2, torch.float32, True, False, 0.1),
    "bf16_bert_bias_drop": (BERT, torch.bfloat16, False, True, 0.1),
    "fp32_bert_bias_drop": (BERT, torch.float32, False, True, 0.1),
    "bf16_varlen_seg": ((1, sum(PACKED), 16, 128), torch.bfloat16, True,
                        False, 0.0),
    "fp32_varlen_seg": ((1, sum(PACKED), 12, 64), torch.float32, True,
                        False, 0.0),
}


STEPS = ("train_bert_padded", "gpt2_bf16", "bert_bf16", "train_gpt2",
         "train_bert_defaults", "train_bert_nodrop", "train_moe_fp32",
         "train_moe")


def _gpu_state() -> str:
    """The card's SM clock (MHz), temperature (C) and power draw (W) now,
    as ``nvidia-smi`` reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,temperature.gpu,power.draw",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.strip()


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--steps", nargs="*", choices=STEPS,
                    help="the steps to run (no name: all of STEPS)")
    ap.add_argument("--rows", nargs="+", choices=list(ROWS),
                    help="the rows to time, in this order (default: every "
                         "row, in ROWS' order)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.tree))
    from paddle_tpu_torch.ops.kernels import build
    from paddle_tpu_torch.ops.kernels import flash_attention as F
    if not os.path.abspath(F.__file__).startswith(os.path.abspath(args.tree)):
        raise SystemExit(f"flash_ab: paddle_tpu_torch came from "
                         f"{F.__file__}, not from {args.tree}")
    built = build.build_all(["flash_attention_fwd", "flash_attention_bwd"])
    # this repository's report parser (an older tree may lack it)
    spec = importlib.util.spec_from_file_location(
        "repo_build", os.path.join(HERE, "paddle_tpu_torch", "ops", "kernels",
                                   "build.py"))
    repo_build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(repo_build)
    report = {f"{name}:{fn}": line for name, b in built.items()
              for fn, line in repo_build.ptxas_report(b["log"]).items()}
    times, gpu = {}, {}
    seed = torch.tensor([7, 11], dtype=torch.int64, device="cuda")
    ids = np.repeat(np.arange(len(PACKED)), PACKED)
    for name in args.rows or ROWS:
        (b, s, h, d), dtype, causal, keypad, p = ROWS[name]
        gen = torch.Generator(device="cuda").manual_seed(
            list(ROWS).index(name))
        seg = F.seg_ids(ids, ids, "cuda") if name.endswith("seg") else None
        mode = (p, seed if p else None, seg)
        sets = []
        for _ in range(3):
            q, k, v, do = (torch.randn((b, s, h, d), generator=gen,
                                       device="cuda").to(dtype)
                           for _ in range(4))
            bias = None
            if keypad:
                lens = torch.randint(128, s + 1, (b,), generator=gen,
                                     device="cuda")
                keep = torch.arange(s, device="cuda")[None, :] < lens[:, None]
                bias = F.attn_bias(keep[:, None, None, :].expand(b, 1, s, s),
                                   q, k)
            out, lse = F.flash_fwd_cuda(q, k, v, d ** -0.5, causal, bias,
                                        *mode)
            sets.append((q, k, v, do, lse, F.flash_delta(do, out), bias,
                         None if bias is None else bias.to(dtype)))
        sc = d ** -0.5
        gpu[name] = {"before": _gpu_state()}
        times[name] = {
            "fwd": _ms(lambda *a: F.flash_fwd_cuda(*a[:3], sc, causal, a[6],
                                                   *mode), sets),
            "dq": _ms(lambda *a: F.flash_bwd_dq_cuda(*a[:6], sc, causal,
                                                     a[6], *mode), sets),
            "dkv": _ms(lambda *a: F.flash_bwd_dkv_cuda(*a[:6], sc, causal,
                                                       a[6], *mode), sets)}
        if seg is None:
            times[name]["sdpa_fwd"] = _ms(
                lambda *a: torch.nn.functional.scaled_dot_product_attention(
                    *(x.transpose(1, 2) for x in a[:3]), attn_mask=a[7],
                    dropout_p=p, is_causal=causal, scale=sc), sets)
        gpu[name]["after"] = _gpu_state()
        del sets
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    train = _train(smi) if args.train else None
    steps = (None if args.steps is None
             else _steps(smi, [n for n in STEPS
                               if not args.steps or n in args.steps]))
    print(json.dumps({"tree": args.tree, "device": smi, "ms": times,
                      "gpu": gpu, "train": train, "steps": steps,
                      "ptxas": report}), flush=True)
    return 0


def _harness():
    """This repository's ``chip_smoke.py`` (whatever tree ``main``
    imported the package from)."""
    spec = importlib.util.spec_from_file_location(
        "repo_smoke", os.path.join(HERE, "chip_smoke.py"))
    S = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(S)
    return S


def _profile_figures(prof) -> dict:
    return {k: prof[k] for k in ("wall_ms", "device_ms", "idle_share",
                                 "device_ms_by_category",
                                 "flash_fwd_kernels", "flash_bwd_kernels",
                                 "grouped_passes", "routing_kernels")
            if prof.get(k)}


def _steps(smi, names) -> dict:
    """The steps ``names`` (of ``STEPS``), each with one profiled step, on
    the package that ``main`` imported."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (BertConfig, BertForPreTraining,
                                         GPTConfig, GPTForCausalLM,
                                         Qwen2MoeConfig, Qwen2MoeForCausalLM)
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.ops.kernels import build
    from paddle_tpu_torch.optimizer import AdamW
    build.build_all(["layer_norm", "rms_norm", "moe_routing",
                     "moe_grouped_gemm"]
                    if {"train_moe_fp32", "train_moe"} & set(names)
                    else ["layer_norm"])
    S = _harness()
    out = {}

    def run(model, args, n_inputs, loss_fn, categories) -> dict:
        res, opt = S._train_steps(torch, K, model, TrainStep, AdamW, args,
                                  n_inputs, loss_fn, S.BERT_STEPS)
        step = TrainStep(model, opt, loss_fn, n_inputs=n_inputs)
        prof = S._step_profile(torch, lambda: step(*args), model, opt,
                               categories)
        return {"step_ms": res["step_ms"],
                "median_step_ms": float(np.median(res["step_ms"][2:])),
                "max_memory_allocated_gb": res["max_memory_allocated_gb"],
                "profile": _profile_figures(prof)}

    if "train_bert_padded" in names:
        cfg = S.bert_config(BertConfig)
        model = BertForPreTraining(cfg, device="cuda", seed=S.SEED)
        args, n_inputs = S.bert_batch(torch, np, cfg, padded=True)
        train, opt = S.phase_train_bert(torch, K, model, TrainStep, AdamW,
                                        args, n_inputs, smi, padded=True)
        prof = S.phase_train_bert_profile(torch, model, opt, TrainStep, args,
                                          n_inputs)
        out["train_bert_padded"] = {
            "step_ms": train["step_ms"],
            "median_step_ms": train["median_step_ms"],
            "max_memory_allocated_gb": train["max_memory_allocated_gb"],
            "profile": _profile_figures(prof)}
        del model, opt, args
        torch.cuda.empty_cache()
    if {"gpt2_bf16", "bert_bf16"} & set(names):
        for arm, model, _, args, n_inputs, loss_of, *_ in S.dropout_bf16_arms(
                torch, np, GPTConfig, GPTForCausalLM, BertConfig,
                BertForPreTraining):
            if arm in names:
                out[arm] = run(model, args, n_inputs, loss_of(model),
                               S._BERT_CATEGORIES if arm == "bert_bf16"
                               else S._GPT2_CATEGORIES)
            del model, args
            torch.cuda.empty_cache()
    if "train_gpt2" in names:
        model = GPTForCausalLM(S.gpt2_config(GPTConfig), device="cuda",
                               seed=S.SEED)
        batch = torch.tensor(np.random.default_rng(S.SEED).integers(
            0, model.config.vocab_size, (S.GPT2_BATCH, S.GPT2_SEQ)),
            device="cuda")
        train, opt = S.phase_train_gpt2(torch, np, K, model, TrainStep,
                                        AdamW, batch, smi)
        step = TrainStep(model, opt, lambda logits, y: model.loss(logits, y))
        prof = S._step_profile(torch, lambda: step(batch, batch), model, opt,
                               S._GPT2_CATEGORIES)
        out["train_gpt2"] = {"step_ms": train["step_ms"],
                             "median_step_ms": train["median_step_ms"],
                             "max_memory_allocated_gb":
                                 train["max_memory_allocated_gb"],
                             "profile": _profile_figures(prof)}
        del model, opt, step, batch
        torch.cuda.empty_cache()
    for arm, cfg in (("train_bert_defaults", BertConfig()),   # dropout 0.1
                     ("train_bert_nodrop", BertConfig(
                         hidden_dropout_prob=0.0,
                         attention_probs_dropout_prob=0.0))):
        if arm not in names:
            continue
        model = BertForPreTraining(cfg, device="cuda", seed=S.SEED)
        args, n_inputs = S.bert_batch(torch, np, cfg, padded=True)
        out[arm] = run(model, args, n_inputs, S._bert_loss(model),
                       S._BERT_CATEGORIES)
        del model, args
        torch.cuda.empty_cache()
    for tag, config in (("train_moe_fp32", S.moe_fp32_config),
                        ("train_moe", S.moe_config)):
        if tag not in names:
            continue
        cfg = config(Qwen2MoeConfig, S.MOE_SEQ)
        model = Qwen2MoeForCausalLM(cfg, device="cuda", seed=S.SEED)
        batch = torch.tensor(np.random.default_rng(S.SEED).integers(
            0, cfg.vocab_size, (S.MOE_BATCH, S.MOE_SEQ)), dtype=torch.int32,
            device="cuda")
        train, opt = S.phase_train_moe(torch, K, model, TrainStep, AdamW,
                                       batch, smi, tag=tag)
        step = TrainStep(model, opt, lambda logits, y: model.loss(logits, y))
        prof = S._step_profile(torch, lambda: step(batch, batch), model, opt,
                               S._MOE_CATEGORIES)
        out[tag] = {"step_ms": train["step_ms"],
                    "median_step_ms": train["median_step_ms"],
                    "max_memory_allocated_gb":
                        train["max_memory_allocated_gb"],
                    "profile": _profile_figures(prof)}
        del model, opt, step, batch
        torch.cuda.empty_cache()
    return out


def _train(smi) -> dict:
    """The Llama train phase and one profiled step on the package that
    ``main`` imported (the tree's), with this repository's harness."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.ops.kernels import build
    from paddle_tpu_torch.optimizer import AdamW
    build.build_all(["rms_norm"])
    S = _harness()
    cfg = S.flagship_config(LlamaConfig, S.TRAIN_SEQ)
    model = LlamaForCausalLM(cfg, device="cuda", seed=S.SEED)
    batch = torch.tensor(np.random.default_rng(S.SEED).integers(
        0, cfg.vocab_size, (S.TRAIN_BATCH, S.TRAIN_SEQ)), dtype=torch.int32,
        device="cuda")
    train, opt = S.phase_train(torch, K, model, TrainStep, AdamW, batch, smi)
    prof = S.phase_train_profile(torch, model, opt, TrainStep, batch)
    del model, opt
    torch.cuda.empty_cache()
    return {"step_ms": train["step_ms"],
            "median_step_ms": train["median_step_ms"], "mfu": train["mfu"],
            "profile": {k: prof[k] for k in ("wall_ms", "device_ms",
                                             "idle_share",
                                             "device_ms_by_category")}}


if __name__ == "__main__":
    sys.exit(main())
