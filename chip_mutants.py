#!/usr/bin/env python3
"""Plant known faults in the flash attention, MoE, int8 paged and
LayerNorm kernels, in the flash bias, fp32 (the mma.sync kernels and the
TF32 wgmma forward and backward), dropout and segment modes and in the
grouped-GEMM kernels' fp32 mode, and show which of ``chip_smoke.py``'s
checks catch each one (a mutation check, on one GPU).

    python3 chip_mutants.py [--only NAME ...]

For the unchanged kernels (``control``) and for each fault below, the
script copies ``paddle_tpu_torch/`` and ``chip_smoke.py`` into a fresh
temporary directory, edits one kernel source there (the repository is
never touched), and runs, in a child process on that copy, the checks
of the fault's kind (the control runs every kind of the faults chosen):

- flash: the flash kernel check of ``chip_smoke.py`` (``_flash_errors``
  with a bitwise repeat of the backward) at the training path's shape,
  q/k/v [4, 2048, 16, 128] bf16 causal, and at ``FLASH_CASES`` (ragged,
  sq != sk, BERT-Base's shape, scores far below 0), and train parity (``train_parity_run``): three training steps of the
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
  ``qwen2_moe_fused`` configuration (a routing fault that makes the
  kernel trap fails ``routing_errors`` by its exception, and the parity
  is then not run);
- paged: the paged kernel checks, each launch repeated bitwise: the
  int8 mode at the serving shapes (``paged_int8_errors``), the bf16 mode
  at ``phase_paged``'s shapes on two argument sets in turn and at the
  long context (``paged_errors``), and the gate sweep with its
  dominant-last-chunk cases (``paged_sweep_errors``); and slice parity
  over the int8 pool (``parity_run(kv_quant=True)``): one decode step
  through the kernels and inside ``plain_reference()`` on a model of
  Llama-3-8B widths with int8 weights, cut to ``INT8_LAYERS`` layers;
- bert: the LayerNorm kernel check (``layer_norm_errors``) at the BERT
  training shape [16384, 768] bf16 with a random weight and bias, the
  flash kernel check in the bias mode (``_flash_errors(bias=)``, the
  backward repeated bitwise) with ``train_bert_padded``'s key-padding
  mask at [32, 512, 12, 64] and with a dense random [4, 8, 512, 512]
  bias, and BERT train parity
  (``bert_parity_run``: ``BERT_PARITY`` and the fp32 reference for the
  gradients bf16 cannot resolve) after 10 padded steps
  of ``bench_bert``'s configuration, as ``train_bert_padded`` leaves it;
- fp32: the fp32 flash kernel check (``flash_fp32_errors``: against fp64,
  within 2x the plain fp32 version's error plus the floor) at GPT-2
  small's shape [8, 1024, 12, 64] causal, at the padded BERT shape
  [32, 512, 12, 64] with its key-padding mask, at [4, 512, 8, 64] with
  a dense random bias (``dense_bias``: -inf entries, a row of -1e30), at
  rows that see one key (``one_key_checks``, with a bias at d 64 and
  128) and at a long causal sequence (``long_chain_check``), and
  ``entry()``'s fp32 train parity (``phase_entry_fp32``'s three steps
  at ``FP32_PARITY``);
- dropout: the dropout kernel check at p 0.1 (``flash_fp32_errors`` at
  GPT-2's shape and at the padded BERT shape with its key-padding mask
  in fp32, ``_flash_errors`` with a bitwise repeat of the backward at
  GPT-2's shape causal and at the padded BERT shape in bf16, all given
  one key) and the bf16 dropout train
  parity (``dropout_bf16_parity_run`` at ``DROP_BF16_PARITY``, the masks
  drawn from one generator state) of both ``dropout_bf16_arms``, GPT-2
  small and BERT-Base in bf16 at dropout 0.1, each after
  ``DROP_BF16_STEPS`` steps;
- moe_fp32: the fp32 grouped-GEMM kernel check (``moe_fp32_errors``:
  against fp64, within 2x the plain fp32 version's error plus the floor)
  at the fp32 slice's shapes (T 8192, E 16, D 1024, H 512), at the
  long-K case ``MOE_FP32_LONG`` (one expert holding all 8192 tokens:
  ``moe_fp32_long_errors``, its failures prefixed ``long_k``) and at the
  long-H case ``MOE_FP32_LONG_H`` (H 8192: ``moe_fp32_long_h_errors``,
  ``long_h``), and the fp32
  MoE train parity of ``phase_train_moe_fp32_parity`` (``FP32_PARITY``,
  the layers' own outputs and input gradients, the routing-margin rule)
  after 10 steps of ``moe_fp32_config``;
- varlen: the segment-mode kernel check (``_flash_errors(seg=)``) on
  ``flash_varlen``'s packed batch, [1, 8760, 16, 128] bf16 causal and
  non-causal, and in place of a train parity ``phase_varlen_packed``:
  the packed entry points against each document alone through the
  no-segment kernels.

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
WGB, WGF = "flash_bwd_wgmma.cuh", "flash_fwd_wgmma.cuh"
TF32 = "flash_bwd_tf32.cuh"
TF32C = "flash_tf32_common.cuh"
TF32F = "flash_fwd_tf32.cuh"
ROUTE, GG = "moe_routing.cu", "moe_grouped_gemm.cu"
PAGED = "paged_attention.cu"
LN = "layer_norm.cu"
COMMON = "flash_common.cuh"
PHILOX = "philox.cuh"
HOP = "hopper.cuh"
INT8_LAYERS = 4
FP8 = ('#include "flash_common.cuh"',
       '#include "flash_common.cuh"\n#include <cuda_fp8.h>')
FP8_WGF = ('#include "flash_wg_common.cuh"',
           '#include "flash_wg_common.cuh"\n#include <cuda_fp8.h>')

# name -> (what it does, [(source, old text, new text), ...][, kind]);
# the kind is "flash" unless given
MUTANTS = {
    "fwd_rows_from_512_x1.07": (
        "wgmma forward: output rows from 512 on scaled by 1.07 (a "
        "systematic 7% error where causal rows are small)",
        [(WGF, "const float l_safe = l == 0.f ? 1.f : l;",
          "const float l_safe = (l == 0.f ? 1.f : l) / "
          "(row[r] >= 512 ? 1.07f : 1.f);")]),
    "fwd_p_fp8": (
        "wgmma forward: P rounded to fp8 e4m3 (not bf16) for the P V "
        "product",
        [(WGF, *FP8_WGF),
         (WGF, "        s[n][i] = p;\n",
          "        s[n][i] = float(__nv_fp8_e4m3(p));\n")]),
    "fwd_diagonal_unmasked": (
        "wgmma forward: the tiles that cross the causal diagonal are not "
        "tested, so each query sees the keys past its own in that tile",
        [(WGF, "const bool edge = (causal && k0 + 63 > r0 + off) || "
               "k0 + 64 > sk;",
          "const bool edge = k0 + 64 > sk;")]),
    "fwd_o_not_rescaled": (
        "wgmma forward: O is not rescaled by alpha when the running max "
        "rises",
        [(WGF, """          o[c][n][0] *= alpha[0];
          o[c][n][1] *= alpha[0];
          o[c][n][2] *= alpha[1];
          o[c][n][3] *= alpha[1];
""", "")]),
    "fwd_lse_without_log_l": (
        "wgmma forward: lse written as the running max alone, without "
        "log l",
        [(WGF, "(m_r[r] + log2f(l)) * flash::kLn2", "m_r[r] * flash::kLn2")]),
    "fwd_stage_released_before_wait": (
        "wgmma forward: a stage goes back to the producer right after the "
        "commit of the P V group that reads it, before wgmma.wait_group",
        [(WGF, """      hop::wg_commit();
      draw(k0);                               // S and P V in flight""",
          """      hop::wg_commit();
      if (lane == 0) hop::mbar_arrive(hop::smem_u32(&empty[sp]));
      draw(k0);                               // S and P V in flight"""),
         (WGF, """      if (lane == 0) hop::mbar_arrive(hop::smem_u32(&empty[sp]));
#pragma unroll
      for (int c = 0; c < NC; ++c)            // O *= alpha""",
          """#pragma unroll
      for (int c = 0; c < NC; ++c)            // O *= alpha""")]),
    "dq_drops_last_k_tile": (
        "dQ: the loop over k tiles stops one tile early (the diagonal "
        "tile, causal)",
        [(BWD, "for (int it = 0; jt < j_end; ++it) {",
          "for (int it = 0; jt < j_end - 1; ++it) {")], "varlen"),
    "dkv_skips_first_q_tile": (
        "dK/dV: the loop over q tiles starts one tile past the diagonal",
        [(BWD, "const int i0 = first / BQ,",
          "const int i0 = first / BQ + 1,")], "varlen"),
    "dkv_p_fp8": (
        "dK/dV: P rounded to fp8 e4m3 (not bf16) for dV += P^T dO",
        [(BWD, *FP8),
         (BWD, "          s[nt][i] = p;                                   // P^T",
          "          s[nt][i] = float(__nv_fp8_e4m3(p));             // P^T")], "varlen"),
    "bwd_stage_released_before_wait": (
        "wgmma dQ and dK/dV: a stage goes back to the producer right after "
        "the commit of the last wgmma group that reads it, before "
        "wgmma.wait_group",
        [(WGB, """      hop::wgmma_rs_chunk<1, NC>(acc, a, st, kAtom);  // dQ += dS K
      hop::wg_commit();
      hop::wg_wait<0>();
    }
    // release stage s: after the wg_wait<0> just above, which covers the
    // S, dP and dQ += dS K groups, every group that read the stage
    if (lane == 0) hop::mbar_arrive(hop::smem_u32(&empty[s]));""",
          """      hop::wgmma_rs_chunk<1, NC>(acc, a, st, kAtom);  // dQ += dS K
      hop::wg_commit();
      if (lane == 0) hop::mbar_arrive(hop::smem_u32(&empty[s]));
      hop::wg_wait<0>();
    } else if (lane == 0) {
      hop::mbar_arrive(hop::smem_u32(&empty[s]));
    }"""),
         (WGB, """      hop::wgmma_rs_chunk<1, NC>(dka, as, st, kAtom);        // dK += dS^T Q
      hop::wg_commit();
      hop::wg_wait<0>();
    }
    // release stage s: after the wg_wait<0> just above, which covers the
    // S^T, dP^T, dV and dK groups, every group that read the stage (its
    // lse and delta were read before them)
    if (lane == 0) hop::mbar_arrive(hop::smem_u32(&empty[s]));""",
          """      hop::wgmma_rs_chunk<1, NC>(dka, as, st, kAtom);        // dK += dS^T Q
      hop::wg_commit();
      if (lane == 0) hop::mbar_arrive(hop::smem_u32(&empty[s]));
      hop::wg_wait<0>();
    } else if (lane == 0) {
      hop::mbar_arrive(hop::smem_u32(&empty[s]));
    }""")]),
    "dkv_diagonal_off_by_one": (
        "wgmma dK/dV: the causal test of the diagonal tiles lets each "
        "query see one key past its own (off + 1)",
        [(WGB, """krow[i >> 1], sq,
                                             sk, off, causal != 0);""",
          """krow[i >> 1], sq,
                                             sk, off + 1, causal != 0);""")]),
    "dq_ds_without_delta": (
        "wgmma dQ: dS = P dP scale, delta left out",
        [(WGB, "sc[n][i] = sc[n][i] * (dpk - dlt[i >> 1]) * scale;",
          "sc[n][i] = sc[n][i] * dpk * scale;")]),
    "dq_b_transpose_flipped": (
        "wgmma dQ: the transpose bit of B (K) in dQ += dS K flipped: K "
        "read K-major from its MN-major tile",
        [(WGB, "hop::wgmma_rs_chunk<1, NC>(acc, a, st, kAtom);  // dQ += dS K",
          "hop::wgmma_rs_chunk<0, NC>(acc, a, st, kAtom);  // dQ += dS K")]),
    "dq_ragged_keys_unmasked": (
        "wgmma dQ: the tile past the last key is not tested, so its keys "
        "(TMA's zeros) take P = exp(-lse)",
        [(WGB, "const bool edge = (causal && k0 + 63 > r0 + off) || "
               "k0 + 64 > sk;",
          "const bool edge = causal && k0 + 63 > r0 + off;")]),
    "moe_scatter_keeps_one_copy": (
        "grouped forward (bf16): the scatter stores instead of adding, so a "
        "token row keeps one of its two experts' contributions",
        [(GG, "        atomicAdd(reinterpret_cast<float2*>(\n"
              "                      dx + (int64_t)row * d.D + dt * 64 + "
              "acc_col(lane, n, i)),\n"
              "                  make_float2(ay[n][i] * w, ay[n][i + 1] * w));",
          "        *reinterpret_cast<float2*>(\n"
          "            dx + (int64_t)row * d.D + dt * 64 + acc_col(lane, n, i))"
          " =\n"
          "                  make_float2(ay[n][i] * w, ay[n][i + 1] * w);")],
        "moe"),
    "moe_fwd_act_on_h1": (
        "grouped forward (bf16), pass 1: the activation applied to h1 (x "
        "W_in) instead of hg (x W_gate) in the gated FFN",
        [(GG, "hv[j] = GATED ? act_f(d.act, hg) * h1 : act_f(d.act, h1);",
          "hv[j] = GATED ? act_f(d.act, h1) * h1 : act_f(d.act, h1);")],
        "moe"),
    "moe_fwd_gate_weight_wg0": (
        "grouped forward (bf16), pass 2: warpgroup 1's rows scattered with "
        "warpgroup 0's gate weights",
        [(GG, "const float w = gw[r];", "const float w = gw[r % 64];")],
        "moe"),
    "moe_dx_drops_gate_branch": (
        "grouped dX (bf16): dx takes dh1 W_in^T only, without dhg "
        "W_gate^T",
        [(GG, "    if constexpr (!FWD && GATED) {   // dhg W_gate^T into the "
              "same accumulator",
          "    if constexpr (false) {   // dhg W_gate^T into the same "
          "accumulator")],
        "moe"),
    "moe_dw_out_without_gate_weight": (
        "grouped dW (bf16): dW_out = h^T g, the gate weight left out of dy",
        [(GG, "        sgw[s][t] = w;",
          "        sgw[s][t] = row >= 0 ? 1.f : 0.f;")], "moe"),
    "moe_dw_skips_last_block": (
        "grouped dW (bf16): the loop over an expert's slots stops one "
        "64-slot chunk short, before the last chunk that holds a token",
        [(GG, "  const int n_chunks = last + 1;",
          "  const int n_chunks = last;")], "moe"),
    "moe_gather_swizzle_off": (
        "grouped dX and dW (bf16): the gathered x and g rows written "
        "unswizzled, while the wgmma descriptors read the 128B swizzle",
        [(HOP, "  return r * 128 + ((c ^ (r & 7)) << 4);",
          "  return r * 128 + (c << 4);")], "moe"),
    "moe_stage_released_early": (
        "grouped dX and dW (bf16): a stage goes back to the producer as "
        "soon as the consumer's wait for it ends, before dy is made and "
        "before the products that read it (and their wgmma.wait_group)",
        [(GG, "  hop::wg_commit();\n  hop::wg_wait<0>();\n"
              "  if (lane == 0) hop::mbar_arrive(ring.e(k));",
          "  hop::wg_commit();\n  hop::wg_wait<0>();"),
         (GG, "  hop::mbar_wait(ring.f(k), Ring<S>::parity(k));\n"
              "  hop::proxy_fence();",
          "  hop::mbar_wait(ring.f(k), Ring<S>::parity(k));\n"
              "  if ((threadIdx.x & 31) == 0) hop::mbar_arrive(ring.e(k));\n"
              "  hop::proxy_fence();"),
         (GG, "    hop::mbar_wait(ring.f(k), Ring<S>::parity(k));\n"
              "    const uint32_t st = base + (k % S) * L::BYTES;",
          "    hop::mbar_wait(ring.f(k), Ring<S>::parity(k));\n"
          "    if (lane == 0) hop::mbar_arrive(ring.e(k));\n"
          "    const uint32_t st = base + (k % S) * L::BYTES;")], "moe"),
    "moe_routing_top2_not_after_top1": (
        "routing: count1 reported as 0, so the top-2 claims take slots "
        "from position 0, on top of the top-1 claims instead of after them",
        [(ROUTE, "count1_out[tid] = (float)(off[tid] + n1);",
          "count1_out[tid] = 0.f;")], "moe"),
    "moe_routing_offset_inclusive": (
        "routing: a tile's offsets summed over its predecessors and itself "
        "(the inclusive count), so its positions start after its own claims",
        [(ROUTE, "  const int n_prev = tile * W2;",
          "  const int n_prev = (tile + 1) * W2;")], "moe"),
    "moe_routing_me_sum_drops_last_tile": (
        "routing: me_sum summed without the last tile's probability sums",
        [(ROUTE, "j1 = min(n_tiles, j0 + per);",
          "j1 = min(n_tiles - 1, j0 + per);")], "moe"),
    "moe_routing_ticket_unreset": (
        "routing: the last block leaves the tile ticket where the call "
        "ended, so the next call's tickets start past the last tile",
        [(ROUTE, "    w->ticket = 0u;\n    w->done = 0u;",
          "    w->done = 0u;")], "moe"),
    "int8_v_scale_dropped": (
        "int8 paged: V codes read as if their row scale were 1",
        [(PAGED, "v *= rsc[j];", "v *= 1.f;")], "paged"),
    "int8_k_scale_wrong_row": (
        "int8 paged: each K row takes the scale of the tile's next live row",
        [(PAGED, "rs = live ? rsc[j] : 0.f;",
          "rs = live ? rsc[(j + 1) % ntt] : 0.f;")],
        "paged"),
    "paged_chunk_drops_last_position": (
        "paged: a full chunk drops its last position (position 63 of "
        "each 64 at serving sizes), at the chunk edge, from its scores and "
        "its PV product",
        [(PAGED, "const int nt = min(chunk, len - t0);",
          "const int nt = min(chunk - 1, len - t0);")], "paged"),
    "paged_max_without_last_chunk": (
        "paged: a PV item takes the context's max without the last "
        "chunk's statistics (the sum is still scaled to that max)",
        [(PAGED, "float m = fmaxf(fmaxf(v[0].x, v[1].x), fmaxf(v[2].x, "
                 "v[3].x));",
          "float m = -CUDART_INF_F;\n#pragma unroll\n"
          "    for (int k = 0; k < 4; ++k)\n"
          "      if (lane + 32 * k < nlive - 1) m = fmaxf(m, v[k].x);")],
        "paged"),
    "paged_partials_arrival_order": (
        "paged: the pair's last PV item adds the other partials in the "
        "order their flags are seen (each thread polling on its own), not "
        "in chunk order",
        [(PAGED, """  for (int i = tid; i < nlive - 1; i += kThreads)
    wait_published(&w.done[first + i]);
  __syncthreads();
  const float* p0 = w.part + first * G * D;
  float tot[kAcc];
#pragma unroll
  for (int a_ = 0; a_ < kAcc; ++a_) {
    const int g = h0 + a_;
    tot[a_] = g < G ? __ldcg(p0 + g * D + tid % D) : 0.f;
  }
#pragma unroll 4
  for (int i = 1; i < nlive - 1; ++i) {
""", """  const float* p0 = w.part + first * G * D;
  float tot[kAcc];
#pragma unroll
  for (int a_ = 0; a_ < kAcc; ++a_) tot[a_] = 0.f;
  for (unsigned long long seen = 0ull; __popcll(seen) < nlive - 1;)
    for (int i = 0; i < nlive - 1 && i < 64; ++i)
      if (!((seen >> i) & 1ull) && ld_acquire(&w.done[first + i]) == 1u) {
        seen |= 1ull << i;
#pragma unroll
        for (int a_ = 0; a_ < kAcc; ++a_) {
          const int g = h0 + a_;
          if (g < G)
            tot[a_] += __ldcg(p0 + (int64_t)i * G * D + g * D + tid % D);
        }
      }
  __syncthreads();
  for (int i = nlive - 1; i < nlive - 1; ++i) {
""")], "paged"),
    "paged_done_flags_unreset": (
        "paged: the pair's last PV item leaves the partials' flags set "
        "where the call ended (the workspace is not left zeroed), so the "
        "next call's last item reads partials before they are written",
        [(PAGED, "    w.done[first + i] = 0u;\n", "")], "paged"),
    "paged_stats_without_wait": (
        "paged: a PV item reads its pair's chunk statistics and scores "
        "without waiting on the score items' flags",
        [(PAGED, "    wait_published(&w.flag[first + i]);",
          "    (void)w.flag[first + i];")], "paged"),
    "ln_drops_shift": (
        "LayerNorm: the shift (bias) is not added",
        [(LN, "v[j][e] = v[j][e] * inv * wf[e] + bf[e];",
          "v[j][e] = v[j][e] * inv * wf[e];")], "bert"),
    "fwd_bias_ignores_query_stride": (
        "wgmma forward, bias mode: every query row reads the bias of query "
        "row 0 (invisible to a key-padding bias, constant over queries)",
        [(WGF, "(int64_t)min(q0 + r, sq - 1) * md.b_sq\n"
               "                               + (valid",
          "(int64_t)0 * md.b_sq\n                               + (valid"),
         (WGF, "(int64_t)min(q0 + r, sq - 1) * md.b_sq\n"
               "                               + (ok",
          "(int64_t)0 * md.b_sq\n                               + (ok")],
        "bert"),
    "dkv_ignores_bias": (
        "wgmma dK/dV, bias mode: P^T recomputed without the bias, while the "
        "forward and dQ apply it",
        [(WGB, "if constexpr (HAS_BIAS) lbt = fmaf(bt[n][i], flash::kLog2e, "
               "lbt);", "")],
        "bert"),
    "dq_bias_row0": (
        "wgmma dQ, bias mode: every query row reads the bias of query row 0 "
        "(invisible to a key-padding bias, constant over queries)",
        [(WGB, "+ (int64_t)min(row[r], sq - 1) * md.b_sq",
          "+ (int64_t)0 * md.b_sq")],
        "bert"),
    "bias_stage_released_before_wait": (
        "wgmma dQ and dK/dV, bias mode only: a stage goes back to the "
        "producer right after the commit of the last wgmma group that reads "
        "it, before wgmma.wait_group",
        [(WGB, """      hop::wgmma_rs_chunk<1, NC>(acc, a, st, kAtom);  // dQ += dS K
      hop::wg_commit();
      hop::wg_wait<0>();
    }
    // release stage s: after the wg_wait<0> just above, which covers the
    // S, dP and dQ += dS K groups, every group that read the stage
    if (lane == 0) hop::mbar_arrive(hop::smem_u32(&empty[s]));""",
          """      hop::wgmma_rs_chunk<1, NC>(acc, a, st, kAtom);  // dQ += dS K
      hop::wg_commit();
      if (HAS_BIAS && lane == 0) hop::mbar_arrive(hop::smem_u32(&empty[s]));
      hop::wg_wait<0>();
      if (!HAS_BIAS && lane == 0) hop::mbar_arrive(hop::smem_u32(&empty[s]));
    } else if (lane == 0) {
      hop::mbar_arrive(hop::smem_u32(&empty[s]));
    }"""),
         (WGB, """      hop::wgmma_rs_chunk<1, NC>(dka, as, st, kAtom);        // dK += dS^T Q
      hop::wg_commit();
      hop::wg_wait<0>();
    }
    // release stage s: after the wg_wait<0> just above, which covers the
    // S^T, dP^T, dV and dK groups, every group that read the stage (its
    // lse and delta were read before them)
    if (lane == 0) hop::mbar_arrive(hop::smem_u32(&empty[s]));""",
          """      hop::wgmma_rs_chunk<1, NC>(dka, as, st, kAtom);        // dK += dS^T Q
      hop::wg_commit();
      if (HAS_BIAS && lane == 0) hop::mbar_arrive(hop::smem_u32(&empty[s]));
      hop::wg_wait<0>();
      if (!HAS_BIAS && lane == 0) hop::mbar_arrive(hop::smem_u32(&empty[s]));
    } else if (lane == 0) {
      hop::mbar_arrive(hop::smem_u32(&empty[s]));
    }""")], "bert"),
    "fp32_operands_bf16": (
        "fp32 flash mode: every operand of the 3xTF32 products rounded to "
        "bf16 first (split_tf32: the mma.sync kernels' fragments and the "
        "TF32 wgmma kernels' split tiles and A fragments alike)",
        [(COMMON, "                                           uint32_t& lo) "
                  "{\n",
          "                                           uint32_t& lo) {\n"
          "  x = __bfloat162float(__float2bfloat16(x));\n")], "fp32"),
    "dkv_mask_col_shift": (
        "wgmma dK/dV, dropout mode: the keep mask drawn with its key (the "
        "score's column) four on, the next Philox block, while the forward "
        "and dQ draw it right",
        [(WGB, "keep = flash::keep_bits_kq(bh, krow[0], krow[1],",
          "keep = flash::keep_bits_kq(bh, krow[0] + 4, krow[1] + 4,")],
        "dropout"),
    "dkv_keep_word_wrong_lane": (
        "dropout mode, dK/dV's lane exchange: each lane takes the keep word "
        "of its neighbour's key (lane j ^ 1 of the four that share a block)",
        [(PHILOX, "out |= ((w >> j) & 0x11111111u) << s;",
          "out |= ((w >> (j ^ 1)) & 0x11111111u) << s;")],
        "dropout"),
    "dkv_dpt_unmasked": (
        "wgmma dK/dV, dropout mode: P^T dropped for dV but dP^T not masked "
        "(nor scaled) before dS^T",
        [(WGB, "if constexpr (DROP) dpt = kept(dpt, keep, 4 * n + i, "
               "md.inv_keep);", "")],
        "dropout"),
    "fwd_drop_l_from_dropped_p": (
        "wgmma forward, dropout mode: the row sums l take the dropped P "
        "(keep ? P / (1 - p) : 0), not the undropped one",
        [(WGF, "        rs[i >> 1] += p;\n",
          "        rs[i >> 1] += DROP ? kept(p, keep, 4 * n + i, md.inv_keep)"
          " : p;\n")],
        "dropout"),
    "fwd_keep_rows_swapped": (
        "wgmma forward, dropout mode: the keep bits drawn with the lane's "
        "two query rows swapped",
        [(WGF, "keep_bits_qk<8>(bh, row[0], row[1],",
          "keep_bits_qk<8>(bh, row[1], row[0],")],
        "dropout"),
    "fwd_keep_col_shift": (
        "wgmma forward, dropout mode: the keep bits drawn with the key "
        "column four on (k0 + 2 t + 4), the next Philox block",
        [(WGF, "row[1], k0 + 2 * t, key0,", "row[1], k0 + 2 * t + 4, key0,")],
        "dropout"),
    "fwd_drop_unscaled": (
        "wgmma forward, dropout mode: the kept P not scaled by 1 / (1 - p) "
        "for P V",
        [(WGF, "acc_to_a_kept(a, sc, keep, md.inv_keep);",
          "acc_to_a_kept(a, sc, keep, 1.f);")],
        "dropout"),
    "moe_fp32_dw_drops_hi_lo": (
        "fp32 grouped dW: its dW_in product drops the hi*lo pass (A's hi "
        "times B's lo); the other fp32 products keep all three",
        [(GG, "      product_add(a1, part, hi, lo, st + QW::D1H, st + QW::D1L);",
          """      hop::wg_fence();
      hop::wgmma64_tf32_rs<false>(part, lo[0], hop::desc(st + QW::D1H));
      for (int ks = 1; ks < 4; ++ks)
        hop::wgmma64_tf32_rs(part, lo[ks], hop::desc(st + QW::D1H + ks * 32));
      for (int ks = 0; ks < 4; ++ks)
        hop::wgmma64_tf32_rs(part, hi[ks], hop::desc(st + QW::D1H + ks * 32));
      hop::wg_commit();
      hop::wg_wait<0>();
      hop::acc_fence(part);
      flash_tf32::add_to(a1, part);""")], "moe_fp32"),
    "moe_fp32_dx_wgate_bf16_map": (
        "fp32 grouped dX pass 2: the dhg fragments (the A operand of dhg "
        "W_gate^T) read with the bf16 fragment's column map (lane (g, t) "
        "takes k 2t and 2t + 1, where the tf32 fragment takes t and t + 4); "
        "the dh1 product unchanged",
        [(GG, """      frag_split<false>(hi2, lo2, st + Q2::DHG + wg * kTile, warp, lane, 1.f,
                        1.f);""",
          """      for (int ks = 0; ks < 4; ++ks)
        for (int i = 0; i < 4; ++i) {
          const int r = 16 * warp + (lane >> 2) + (i & 1) * 8;
          const int c = 8 * ks + 2 * (lane & 3) + (i >> 1);
          const float v = lds(st + Q2::DHG + wg * kTile
                              + hop::swz(r, c >> 2) + 4 * (c & 3));
          flash::split_tf32(v, hi2[ks][i], lo2[ks][i]);
        }""")], "moe_fp32"),
    "moe_fp32_dw_passes_into_running": (
        "fp32 grouped dW: the dW_out product's three passes summed into its "
        "running accumulator on the tensor cores instead of a fresh one "
        "added on the CUDA cores (a truncating chain over every slot chunk "
        "of the expert)",
        [(GG, "      product_add(a3, part, hi, lo, st + QW::HH, st + QW::HL);",
          """      hop::wg_fence();
      flash_tf32::product_rs<false>(a3, hi, lo, st + QW::HH, st + QW::HL);
      hop::wg_commit();
      hop::wg_wait<0>();
      hop::acc_fence(a3);""")], "moe_fp32"),
    "moe_fp32_dx2_drops_hi_lo": (
        "fp32 grouped dX pass 2: the dh1 W_in^T product drops its hi*lo "
        "pass (dh1's hi times W_in's lo)",
        [(GG, "      flash_tf32::product_rs(part, hi, lo, st + Q2::WIH, "
              "st + Q2::WIL);",
          """      hop::wgmma64_tf32_rs<false>(part, lo[0], hop::desc(st + Q2::WIH));
      for (int ks = 1; ks < 4; ++ks)
        hop::wgmma64_tf32_rs(part, lo[ks], hop::desc(st + Q2::WIH + ks * 32));
      for (int ks = 0; ks < 4; ++ks)
        hop::wgmma64_tf32_rs(part, hi[ks], hop::desc(st + Q2::WIH + ks * 32));""")],
        "moe_fp32"),
    "moe_fp32_wt_k_renamed": (
        "fp32 grouped GEMMs: split_hilo_kernel writes the transposed hi and "
        "lo copies (W_in^T, W_gate^T, W_out^T; dW's h^T, dh1^T, dhg^T) in "
        "the renamed k order of flash_tf32::renamed (what an accumulator's A "
        "operand needs) where the A fragments read k in plain order",
        [(GG, "    const int64_t o = base + (int64_t)c * R + r;",
          "    const int64_t o = base + (int64_t)c * R\n"
          "                      + ((r & ~7) | ((r & 7) >> 1) | ((r & 1) << 2));")],
        "moe_fp32"),
    "moe_fp32_dw_dy_without_gate": (
        "fp32 grouped dW: dW_out's dy^T taken from g without the gate "
        "weight (g^T h where the plain version has (g gate_w)^T h)",
        [(GG, "      frag_split_t<true>(hi, lo, st + QW::G, 64 * wg, warp, lane, "
              "cgw[s]);",
          "      frag_split_t<false>(hi, lo, st + QW::G, 64 * wg, warp, lane, "
          "cgw[s]);")], "moe_fp32"),
    "moe_fp32_stage_released_before_wait": (
        "fp32 grouped dW: a live stage goes back to the producer right after "
        "the commit of its last product (dW_out's, reading the stage's h^T "
        "tiles), before wgmma.wait_group",
        [(GG, """      product_add(a3, part, hi, lo, st + QW::HH, st + QW::HL);
    }
    // release stage s: after the wg_wait<0> of the last product above,
    // the last group that read it (none for a chunk without tokens)
    if (lane == 0) hop::mbar_arrive(ring.e(c));
  }""",
          """      hop::wg_fence();
      flash_tf32::product_rs(part, hi, lo, st + QW::HH, st + QW::HL);
      hop::wg_commit();
      if (lane == 0) hop::mbar_arrive(ring.e(c));
      hop::wg_wait<0>();
      hop::acc_fence(part);
      flash_tf32::add_to(a3, part);
    } else if (lane == 0) {
      hop::mbar_arrive(ring.e(c));
    }
  }""")], "moe_fp32"),
    "moe_fp32_fwd1_drops_hi_lo": (
        "fp32 grouped forward, pass 1: x W_in drops its hi*lo pass (x's hi "
        "times W_in^T's lo); dX's pass 1 unchanged",
        [(GG, """      product_add<FWD>(a1[h], part, hi, lo, st + Q::WIH + o,
                       st + Q::WIL + o);""",
          """      if constexpr (FWD) {
        hop::wg_fence();
        hop::wgmma64_tf32_rs<false>(part, lo[0], hop::desc(st + Q::WIH + o));
        for (int ks = 1; ks < 4; ++ks)
          hop::wgmma64_tf32_rs(part, lo[ks],
                               hop::desc(st + Q::WIH + o + ks * 32));
        for (int ks = 0; ks < 4; ++ks)
          hop::wgmma64_tf32_rs(part, hi[ks],
                               hop::desc(st + Q::WIH + o + ks * 32));
        hop::wg_commit();
        hop::wg_wait<0>();
        hop::acc_fence(part);
        flash_tf32::add_to(a1[h], part);
      } else {
        product_add<FWD>(a1[h], part, hi, lo, st + Q::WIH + o,
                         st + Q::WIL + o);
      }""")], "moe_fp32"),
    "moe_fp32_fwd2_passes_into_running": (
        "fp32 grouped forward, pass 2: y's three passes summed into its "
        "running accumulator on the tensor cores instead of a fresh one "
        "added on the CUDA cores (a truncating chain over every 32-deep "
        "chunk of H); dX's pass 2 unchanged",
        [(GG, """      product_add(ay[h], part, hi, lo, st + Q::WOH + h * Q::HALF,
                  st + Q::WOL + h * Q::HALF);""",
          """      if constexpr (FWD) {
        hop::wg_fence();
        flash_tf32::product_rs<false>(ay[h], hi, lo,
                                      st + Q::WOH + h * Q::HALF,
                                      st + Q::WOL + h * Q::HALF);
        hop::wg_commit();
        hop::wg_wait<0>();
        hop::acc_fence(ay[h]);
      } else {
        product_add(ay[h], part, hi, lo, st + Q::WOH + h * Q::HALF,
                    st + Q::WOL + h * Q::HALF);
      }""")], "moe_fp32"),
    "moe_fp32_fwd_scatter_without_gate": (
        "fp32 grouped forward, pass 2: out[row] += y, the gate weight left "
        "out of the scatter",
        [(GG, "make_float2(ay[h][n][i] * gwr, ay[h][n][i + 1] * gwr)",
          "make_float2(ay[h][n][i], ay[h][n][i + 1])")], "moe_fp32"),
    "moe_fp32_fwd_gate_weight_wg0": (
        "fp32 grouped forward, pass 2: warpgroup 1's rows scattered with "
        "warpgroup 0's gate weights",
        [(GG, "const float gwr = gw[r];", "const float gwr = gw[r % 64];")],
        "moe_fp32"),
    "moe_fp32_fwd_stage_released_before_wait": (
        "fp32 grouped forward, pass 2: a stage goes back to the producer "
        "right after the commit of its last product (y's second 64-column "
        "half, reading the stage's h and W_out^T tiles), before "
        "wgmma.wait_group",
        [(GG, """#pragma unroll
    for (int h = 0; h < ND; ++h)
      product_add(ay[h], part, hi, lo, st + Q::WOH + h * Q::HALF,
                  st + Q::WOL + h * Q::HALF);
    // release stage k: after the wg_wait<0> of the y product just above,
    // the last group that read it
    if (lane == 0) hop::mbar_arrive(ring.e(k));""",
          """    if constexpr (FWD) {
      product_add(ay[0], part, hi, lo, st + Q::WOH, st + Q::WOL);
      hop::wg_fence();
      flash_tf32::product_rs(part, hi, lo, st + Q::WOH + Q::HALF,
                             st + Q::WOL + Q::HALF);
      hop::wg_commit();
      if (lane == 0) hop::mbar_arrive(ring.e(k));
      hop::wg_wait<0>();
      hop::acc_fence(part);
      flash_tf32::add_to(ay[1], part);
    } else {
      product_add(ay[0], part, hi, lo, st + Q::WOH, st + Q::WOL);
      if (lane == 0) hop::mbar_arrive(ring.e(k));
    }""")], "moe_fp32"),
    "c6_repair_reverted": (
        "fp32 flash backward: dP = dO V^T back to three 3xTF32 passes (no "
        "lo*lo), the product before the ROADMAP C6 repair, in the mma.sync "
        "and the TF32 wgmma kernels",
        [(BWD, "nt_product_f32<kBK / 8, D, LD, mma4>(dp,",
          "nt_product_f32<kBK / 8, D, LD, mma3>(dp,"),
         (BWD, "nt_product_f32<BQ / 8, D, LD, mma4>(dp,",
          "nt_product_f32<BQ / 8, D, LD, mma3>(dp,"),
         (TF32C, "constexpr int first = FOUR ? 0 : 1;",
          "constexpr int first = 1;")],
        "fp32"),
    "tf32_dq_drops_hi_lo": (
        "TF32 wgmma dQ: dQ += dS K drops its hi*lo pass (dS's hi times "
        "K^T's lo); dK/dV keeps all three",
        [(TF32, """      product_rs(part, ahi, alo, st + 4 * kTile, st + 4 * kTile + kTrans);
      hop::wg_commit();                          // dQ's part = dS K""",
          """      hop::wgmma64_tf32_rs<false>(part, alo[0],
                                  hop::desc(st + 4 * kTile));
      for (int kk = 1; kk < 4; ++kk)
        hop::wgmma64_tf32_rs(part, alo[kk],
                             hop::desc(st + 4 * kTile + kk * 32));
      for (int kk = 0; kk < 4; ++kk)
        hop::wgmma64_tf32_rs(part, ahi[kk],
                             hop::desc(st + 4 * kTile + kk * 32));
      hop::wg_commit();                          // dQ's part = dS K""")],
        "fp32"),
    "tf32_kt_unrenamed": (
        "TF32 wgmma dQ: the transposed K copy written in the natural key "
        "order, not the renamed one of the RS A fragment (dS's columns "
        "2t, 2t + 1 meet K^T's keys t, t + 4)",
        [(TF32, "const int kcol = renamed(lane);", "const int kcol = lane;")],
        "fp32"),
    "tf32_dk_part_into_running": (
        "TF32 wgmma dK/dV: dK's three passes summed into the running dK "
        "accumulator on the tensor cores instead of a fresh one added on "
        "the CUDA cores (a truncating chain over every q tile)",
        [(TF32, """    hop::wg_fence();
    product_rs(part, ahi, alo, st + 4 * kTile, st + 4 * kTile + kTrans);
    hop::wg_commit();                            // dK's part = dS^T Q
    hop::wg_wait<0>();
    hop::acc_fence(part);
    add_to(dka, part);""",
          """    hop::wg_fence();
    for (int kk = 0; kk < 4; ++kk)
      hop::wgmma64_tf32_rs(dka, alo[kk], hop::desc(st + 4 * kTile + kk * 32));
    for (int kk = 0; kk < 4; ++kk)
      hop::wgmma64_tf32_rs(dka, ahi[kk],
                           hop::desc(st + 4 * kTile + kTrans + kk * 32));
    for (int kk = 0; kk < 4; ++kk)
      hop::wgmma64_tf32_rs(dka, ahi[kk], hop::desc(st + 4 * kTile + kk * 32));
    hop::wg_commit();                            // dK's part = dS^T Q
    hop::wg_wait<0>();
    hop::acc_fence(dka);""")],
        "fp32"),
    "tf32_dkv_keep_word_wrong_lane": (
        "TF32 wgmma dK/dV, dropout mode: each lane takes the keep word of "
        "lane ^ 4 (the next key row of its quad) after the exchange",
        [(TF32, """      keep = flash::keep_bits_kq<4>(bh, krow[0], krow[1], qs0 + 2 * t, key0,
                                    key1, md.thresh, lane);""",
          """      keep = __shfl_xor_sync(0xffffffffu, flash::keep_bits_kq<4>(
          bh, krow[0], krow[1], qs0 + 2 * t, key0, key1, md.thresh, lane),
          4);""")],
        "dropout"),
    "tf32_stage_released_before_wait": (
        "TF32 wgmma dQ and dK/dV: a stage goes back to the producer right "
        "after the commit of the last wgmma group that reads it, before "
        "wgmma.wait_group",
        [(TF32, """      hop::wg_commit();                          // dQ's part = dS K
      hop::wg_wait<0>();""",
          """      hop::wg_commit();                          // dQ's part = dS K
      if (lane == 0) hop::mbar_arrive(hop::smem_u32(&empty[s]));
      hop::wg_wait<0>();"""),
         (TF32, """    // release stage s (K, V and their split and transposed copies): after
    // the wg_wait<0> just above, which covers the S, dP and dS K groups,
    // every group that read the stage
    if (lane == 0) hop::mbar_arrive(hop::smem_u32(&empty[s]));""",
          """    else if (lane == 0) hop::mbar_arrive(hop::smem_u32(&empty[s]));"""),
         (TF32, """    hop::wg_commit();                            // dK's part = dS^T Q
    hop::wg_wait<0>();""",
          """    hop::wg_commit();                            // dK's part = dS^T Q
    if (lane == 0) hop::mbar_arrive(hop::smem_u32(&empty[s]));
    hop::wg_wait<0>();"""),
         (TF32, """    // release the stage (Q, dO, their split and transposed copies, lse
    // and delta): after the wg_wait<0> just above, which covers the S^T,
    // dP^T, dV and dK groups, every group that read it
    if (lane == 0) hop::mbar_arrive(hop::smem_u32(&empty[s]));""", "")],
        "fp32"),
    "tf32_dkv_bias_untransposed": (
        "TF32 wgmma dK/dV, bias mode: its (key row, q column) element reads "
        "bias[key, q], the bias in dQ's frame, not bias[q, key]",
        [(TF32, """                + (int64_t)min(krow[r], sk - 1) * md.b_sk
                + (int64_t)(2 * t) * md.b_sq;""",
          """                + (int64_t)min(krow[r], sk - 1) * md.b_sq
                + (int64_t)(2 * t) * md.b_sk;"""),
         (TF32, """      const float* bq[2] = {bkey[0] + (int64_t)qs0 * md.b_sq,
                            bkey[1] + (int64_t)qs0 * md.b_sq};""",
          """      const float* bq[2] = {bkey[0] + (int64_t)qs0 * md.b_sk,
                            bkey[1] + (int64_t)qs0 * md.b_sk};"""),
         (TF32, "flash_wg::bias_chunk(bt[n], bq, md.b_sq, n, "
                "qs0 + 2 * t, sq);",
          "flash_wg::bias_chunk(bt[n], bq, md.b_sk, n, qs0 + 2 * t, sq);")],
        "fp32"),
    "tf32_bias_without_log2e": (
        "TF32 wgmma dQ and dK/dV, bias mode: the bias added to the base-2 "
        "exponent as it is, without its log2(e) factor",
        [(TF32, "if constexpr (HAS_BIAS) lb = fmaf(bb[n][i], flash::kLog2e, "
                "lb);",
          "if constexpr (HAS_BIAS) lb = bb[n][i] + lb;"),
         (TF32, "if constexpr (HAS_BIAS) lbt = fmaf(bt[n][i], flash::kLog2e, "
                "lbt);",
          "if constexpr (HAS_BIAS) lbt = bt[n][i] + lbt;")],
        "fp32"),
    "tf32_dq_bias_row0": (
        "TF32 wgmma dQ, bias mode: a lane's second row (row + 8) reads its "
        "first row's bias",
        [(TF32, """      brow[r] = md.bias + bi * md.b_sb + hi * md.b_sh
                + (int64_t)min(row[r], sq - 1) * md.b_sq""",
          """      brow[r] = md.bias + bi * md.b_sb + hi * md.b_sh
                + (int64_t)min(row[0], sq - 1) * md.b_sq""")],
        "fp32"),
    "tf32_lse_unclamped": (
        "TF32 wgmma dQ and dK/dV: lse read without its clamp at -1e25, so "
        "a row whose bias is -1e30 throughout (lse -1e30) takes (bias - "
        "lse) log2e as a rounding residue, not -1e30: P = inf",
        [(TF32, "lse2[r] = ok ? fmaxf(lse[(int64_t)bh * sq + row[r]], "
                "flash::kClamp)",
          "lse2[r] = ok ? fmaxf(lse[(int64_t)bh * sq + row[r]], "
          "-3.0e38f)"),
         (TF32, "l2 = fmaxf(lse[(int64_t)bh * sq + q], flash::kClamp)",
          "l2 = fmaxf(lse[(int64_t)bh * sq + q], -3.0e38f)")],
        "fp32"),
    "tf32_fwd_pv_into_running": (
        "TF32 wgmma forward: P V's three passes summed into O on the "
        "tensor cores (O rescaled by alpha first) instead of a fresh "
        "accumulator added on the CUDA cores (a truncating chain over "
        "every k tile); the last tile's part unchanged",
        [(TF32F, """      hop::wg_fence();
      s_product(st);                          // S, tile j
      hop::wg_commit();
      product_rs(part, ahi, alo, stp + 3 * kTile,
                 stp + 3 * kTile + kTrans);   // part = P V, tile j - 1""",
          """      for (int n = 0; n < 8; ++n)
        for (int i = 0; i < 4; ++i) o[n][i] *= alpha[i >> 1];
      hop::wg_fence();
      s_product(st);                          // S, tile j
      hop::wg_commit();
      for (int kk = 0; kk < 4; ++kk)
        hop::wgmma64_tf32_rs(o, alo[kk],
                             hop::desc(stp + 3 * kTile + kk * 32));
      for (int kk = 0; kk < 4; ++kk)
        hop::wgmma64_tf32_rs(o, ahi[kk],
                             hop::desc(stp + 3 * kTile + kTrans + kk * 32));
      for (int kk = 0; kk < 4; ++kk)
        hop::wgmma64_tf32_rs(o, ahi[kk],
                             hop::desc(stp + 3 * kTile + kk * 32));"""),
         (TF32F, "      rescale_add(o, a_prev, part);\n",
          "      hop::acc_fence(o);\n")],
        "fp32"),
    "tf32_fwd_pv_drops_hi_lo": (
        "TF32 wgmma forward: P V drops its hi*lo pass (P's hi times V^T's "
        "lo) on every tile but the last",
        [(TF32F, """      product_rs(part, ahi, alo, stp + 3 * kTile,
                 stp + 3 * kTile + kTrans);   // part = P V, tile j - 1""",
          """      hop::wgmma64_tf32_rs<false>(part, alo[0],
                                  hop::desc(stp + 3 * kTile));
      for (int kk = 1; kk < 4; ++kk)
        hop::wgmma64_tf32_rs(part, alo[kk],
                             hop::desc(stp + 3 * kTile + kk * 32));
      for (int kk = 0; kk < 4; ++kk)
        hop::wgmma64_tf32_rs(part, ahi[kk],
                             hop::desc(stp + 3 * kTile + kk * 32));""")],
        "fp32"),
    "tf32_fwd_drop_l_from_dropped_p": (
        "TF32 wgmma forward, dropout mode: the row sums l take the dropped "
        "P (keep ? P / (1 - p) : 0), not the undropped one",
        [(TF32F, "        rs[i >> 1] += p;\n",
          "        rs[i >> 1] += DROP ? kept(p, keep, 4 * n + i, md.inv_keep)"
          " : p;\n")],
        "dropout"),
    "tf32_fwd_keep_rows_swapped": (
        "TF32 wgmma forward, dropout mode: the keep bits drawn with the "
        "lane's two query rows swapped",
        [(TF32F, "keep_bits_qk<4>(bh, row[0], row[1],",
          "keep_bits_qk<4>(bh, row[1], row[0],")],
        "dropout"),
    "tf32_fwd_bias_without_query_stride": (
        "TF32 wgmma forward, bias mode: every query row reads the bias of "
        "row 0 (the query stride left out), which a key-padding bias "
        "(query stride 0) cannot show",
        [(TF32F, "                + (int64_t)min(row[r], sq - 1) * md.b_sq\n",
          "")],
        "fp32"),
    "tf32_fwd_stage_released_before_wait": (
        "TF32 wgmma forward: a stage goes back to the producer right after "
        "the commit of its P V, before wgmma.wait_group",
        [(TF32F, """      hop::wg_commit();
      under(k0);                              // S and P V in flight""",
          """      hop::wg_commit();
      if (lane == 0) hop::mbar_arrive(hop::smem_u32(&empty[sp]));
      under(k0);                              // S and P V in flight"""),
         (TF32F, """      // release stage sp (tile j - 1): after the wg_wait<0> just above,
      // which covers its P V, the last group that read it (its S was
      // waited for in the iteration before)
      if (lane == 0) hop::mbar_arrive(hop::smem_u32(&empty[sp]));
""", "")],
        "fp32"),
    "dkv_ignores_seg": (
        "segment mode, dK/dV: the segment test inside a live tile dropped "
        "(a key row takes the queries of every segment its tile meets), "
        "while the forward and dQ apply it",
        [(BWD, "same = same_ids<BQ / 8>(seg_q, qs0, sq, skey, t);",
          "same = ~0u;")], "varlen"),
    "seg_touching_ranges_disjoint": (
        "segment mode: the tile-range test treats ranges that touch (share "
        "one id) as disjoint, an off-by-one, so the kernels skip tiles "
        "that hold kept pairs",
        [(COMMON, "return alo <= bhi && blo <= ahi;",
          "return alo < bhi && blo < ahi;")], "varlen"),
}

HERE = os.path.dirname(os.path.abspath(__file__))


def _copy(name: str) -> str:
    """A copy of the package and chip_smoke.py with mutant ``name``, and
    of the kernels this tree has built (``build/kernels``: a library is
    named by its source's digest, so the copy rebuilds only the source
    the mutant edits)."""
    root = tempfile.mkdtemp(prefix=f"mutant-{name}-")
    shutil.copytree(os.path.join(HERE, "paddle_tpu_torch"),
                    os.path.join(root, "paddle_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    built = os.path.join(HERE, "build", "kernels")
    if os.path.isdir(built):
        shutil.copytree(built, os.path.join(root, "build", "kernels"),
                        ignore=shutil.ignore_patterns("*.tmp"))
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
    flash = S._flash_errors(torch, F, q, k, v, do, d ** -0.5, True,
                            repeat=True)
    del q, k, v, do
    torch.cuda.empty_cache()
    flash["cases"] = S.flash_case_errors(torch, F, gen)
    flash["failures"] += [f"{list(c)}: {f}" for c, e in
                          zip(S.FLASH_CASES, flash["cases"])
                          for f in e["failures"]]
    cfg = S.flagship_config(LlamaConfig, S.TRAIN_SEQ)
    model = LlamaForCausalLM(cfg, device="cuda", seed=S.SEED)
    batch = torch.tensor(np.random.default_rng(S.SEED).integers(
        0, cfg.vocab_size, (S.TRAIN_BATCH, S.TRAIN_SEQ)), dtype=torch.int32,
        device="cuda")
    opt = AdamW(learning_rate=S.TRAIN_LR, parameters=model)
    step = TrainStep(model, opt, lambda logits, y: model.loss(logits, y))
    for _ in range(S.TRAIN_STEPS):
        step(batch, batch)
    parity = S.train_parity_run(torch, K, model, opt, TrainStep,
                                *S.causal_lm_args(model, batch))
    del model, opt, step
    torch.cuda.empty_cache()
    return flash, parity


def _moe_checks(torch, S, K, TrainStep, AdamW) -> tuple:
    from paddle_tpu_torch.models import Qwen2MoeConfig, Qwen2MoeForCausalLM
    from paddle_tpu_torch.ops.kernels import moe_grouped_gemm as GG
    from paddle_tpu_torch.ops.kernels import moe_routing as MR
    gen = torch.Generator(device="cuda").manual_seed(S.SEED + 5)
    inp = S.moe_inputs(torch, GG, MR, gen)
    try:
        route = S.routing_errors(torch, MR, inp["logits"], inp["u"])
    except RuntimeError as e:      # a kernel that traps: the smoke fails
        return ({"failures": [f"routing_errors raised: {str(e)[:300]}"]},
                {"failures": [], "not_run": "the CUDA context is lost"})
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
        torch, K, model, opt, TrainStep, *S.causal_lm_args(model, batch),
        kernels=S.FLASH_KERNELS + S.MOE_KERNELS, limits=S.MOE_PARITY,
        reseed=lambda: model.generator.manual_seed(S.SEED + 6),
        probes=S.moe_probes(model), probe_limits=S.MOE_PROBE_LIMITS)
    return check, parity


def _moe_fp32_checks(torch, S, K, TrainStep, AdamW) -> tuple:
    from paddle_tpu_torch.models import Qwen2MoeConfig, Qwen2MoeForCausalLM
    from paddle_tpu_torch.ops.kernels import moe_grouped_gemm as GG
    from paddle_tpu_torch.ops.kernels import moe_routing as MR
    gen = torch.Generator(device="cuda").manual_seed(S.SEED + 13)
    inp = S.moe_inputs(torch, GG, MR, gen, H=S.MOE_FP32_H, dtype="float32")
    check = S.moe_fp32_errors(torch, GG, inp["x"], inp["row_id"],
                              inp["gate_w"], inp["wi"], inp["wg"],
                              inp["wo"], inp["g"])
    del inp
    torch.cuda.empty_cache()
    check["long_k"] = S.moe_fp32_long_errors(torch, GG, MR, gen)
    check["failures"] += [f"long_k {f}" for f in check["long_k"]["failures"]]
    check["long_h"] = S.moe_fp32_long_h_errors(torch, GG, MR, gen)
    check["failures"] += [f"long_h {f}" for f in check["long_h"]["failures"]]
    torch.cuda.empty_cache()
    cfg = S.moe_fp32_config(Qwen2MoeConfig, S.MOE_SEQ)
    model = Qwen2MoeForCausalLM(cfg, device="cuda", seed=S.SEED)
    batch = torch.tensor(np.random.default_rng(S.SEED).integers(
        0, cfg.vocab_size, (S.MOE_BATCH, S.MOE_SEQ)), dtype=torch.int32,
        device="cuda")
    opt = AdamW(learning_rate=S.TRAIN_LR, parameters=model)
    step = TrainStep(model, opt, lambda logits, y: model.loss(logits, y))
    for _ in range(S.MOE_STEPS):
        step(batch, batch)
    try:
        parity = S.phase_train_moe_fp32_parity(torch, K, model, opt,
                                               TrainStep, batch)
    except AssertionError as e:    # the phase's own failures, reported
        parity = {"failures": [str(e)[:2000]]}
    del model, opt, step
    torch.cuda.empty_cache()
    return check, parity


def _paged_checks(torch, S, K, TrainStep, AdamW) -> tuple:
    from paddle_tpu_torch import quantization as QZ
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_3_8b
    from paddle_tpu_torch.serving import ServingEngine
    gen = torch.Generator(device="cuda").manual_seed(S.SEED + 7)
    check = {"int8": S.paged_int8_errors(
        torch, K, S.paged_int8_inputs(torch, QZ, gen, 1)[0])}
    # the bf16 serving shapes, two sets in turn (a statistic read before
    # it is published then finds the other set's in the workspace)
    sets = S.paged_inputs(torch, torch.Generator(device="cuda").manual_seed(
        S.SEED + 1), n_sets=2)
    check["bf16_set1"] = S.paged_errors(torch, K, sets[1])
    check["bf16"] = S.paged_errors(torch, K, sets[0])
    del sets
    long = S.paged_inputs(torch, torch.Generator(device="cuda").manual_seed(
        S.SEED + 21), S.LONG_CONTEXTS, M=S.LONG_PAGES, n_sets=1)
    check["long_bf16"] = S.paged_errors(torch, K, long[0])
    del long
    check["sweep"] = S.paged_sweep_errors(torch, K, QZ, torch.Generator(
        device="cuda").manual_seed(S.SEED + 23))
    check["failures"] = [f"{k}: {f}" for k, v in check.items()
                         for f in v["failures"]]
    torch.cuda.empty_cache()
    cfg = llama_3_8b(dtype="bfloat16")
    cfg.num_hidden_layers = INT8_LAYERS
    model = QZ.quantize_for_serving(
        LlamaForCausalLM(cfg, device="cuda", seed=S.SEED), inplace=True)
    parity = S.parity_run(torch, np, model, ServingEngine, K, kv_quant=True)
    del model
    torch.cuda.empty_cache()
    return check, parity


def _bert_checks(torch, S, K, TrainStep, AdamW) -> tuple:
    from paddle_tpu_torch.models import BertConfig, BertForPreTraining
    from paddle_tpu_torch.ops.kernels import flash_attention as F
    gen = torch.Generator(device="cuda").manual_seed(S.SEED + 9)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()

    x = (torch.randn((S.BERT_BATCH * S.BERT_SEQ, 768), generator=gen,
                     device="cuda") * 3 + 1).bfloat16()
    ln = S.layer_norm_errors(torch, K, x, rand(768), rand(768), 1e-12)
    b, s, h, d = S.BERT_BATCH, S.BERT_SEQ, 12, 64
    q, k, v, do = (rand(b, s, h, d) for _ in range(4))
    lens = torch.tensor(S.bert_lengths(np), device="cuda")
    keep = (torch.arange(s, device="cuda")[None, :] < lens[:, None])
    keypad = S._flash_errors(
        torch, F, q, k, v, do, d ** -0.5, False,
        bias=F.attn_bias(keep[:, None, None, :].expand(b, 1, s, s), q, k),
        repeat=True)
    q, k, v, do = (rand(4, 512, 8, d) for _ in range(4))
    dense = torch.randn((4, 8, 512, 512), generator=gen, device="cuda") * 2
    dense = S._flash_errors(torch, F, q, k, v, do, d ** -0.5, False,
                            bias=F.pad_bias(dense, 4, 8, 512, 512),
                            repeat=True)
    check = {"layer_norm": ln, "flash_keypad": keypad,
             "flash_dense": dense,
             "failures": ln["failures"] + keypad["failures"]
             + dense["failures"]}
    del q, k, v, do, x
    torch.cuda.empty_cache()
    cfg = S.bert_config(BertConfig)
    model = BertForPreTraining(cfg, device="cuda", seed=S.SEED)
    args, n_inputs = S.bert_batch(torch, np, cfg, padded=True)
    opt = AdamW(learning_rate=S.TRAIN_LR, parameters=model)
    step = TrainStep(model, opt, S._bert_loss(model), n_inputs=n_inputs)
    for _ in range(S.BERT_STEPS):
        step(*args)
    parity = S.bert_parity_run(torch, K, model, opt, TrainStep,
                               BertForPreTraining, args, n_inputs)
    parity.pop("bf16_noise")
    del model, opt, step
    torch.cuda.empty_cache()
    return check, parity


def _fp32_checks(torch, S, K, TrainStep, AdamW) -> tuple:
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops.kernels import flash_attention as F
    gen = torch.Generator(device="cuda").manual_seed(S.SEED + 12)
    q, k, v, do = S._flash_inputs(torch, gen, S.GPT2_SHAPE, torch.float32)
    check = {"gpt2": S.flash_fp32_errors(torch, F, q, k, v, do, 0.125,
                                         True)}
    b, s = S.BERT_BATCH, S.BERT_SEQ
    keep, _ = S._keypad(torch, np, s)
    q, k, v, do = S._flash_inputs(torch, gen, (b, s, 12, 64), torch.float32)
    check["bert_keypad"] = S.flash_fp32_errors(
        torch, F, q, k, v, do, 0.125, False,
        F.attn_bias(keep.expand(b, 1, s, s), q, k))
    q, k, v, do = S._flash_inputs(torch, gen, (4, 512, 8, 64), torch.float32)
    check["dense_d64"] = S.flash_fp32_errors(
        torch, F, q, k, v, do, 0.125, False, S.dense_bias(torch, F, gen, q, k))
    del q, k, v, do
    check.update(S.one_key_checks(torch, np, F))
    check["long_chain"] = S.long_chain_check(torch, F, gen)
    check["failures"] = [f"{n}: {f}" for n, c in check.items()
                         for f in c["failures"]]
    torch.cuda.empty_cache()
    try:
        entry = S.phase_entry_fp32(torch, np, K, LlamaConfig,
                                   LlamaForCausalLM, TrainStep, AdamW)
        parity = dict(entry["parity"], failures=[])
    except AssertionError as e:    # the phase's own failures, reported
        parity = {"failures": [str(e)[:2000]]}
    return check, parity


def _dropout_checks(torch, S, K, TrainStep, AdamW) -> tuple:
    from paddle_tpu_torch.models import (BertConfig, BertForPreTraining,
                                         GPTConfig, GPTForCausalLM)
    from paddle_tpu_torch.ops.kernels import flash_attention as F
    gen = torch.Generator(device="cuda").manual_seed(S.SEED + 13)
    seed = torch.tensor([S.SEED + 13, (1 << 31) + 5], dtype=torch.int64,
                        device="cuda")
    q, k, v, do = S._flash_inputs(torch, gen, S.GPT2_SHAPE, torch.float32)
    fp32 = S.flash_fp32_errors(torch, F, q, k, v, do, 0.125, True, None,
                               S.DROP_P, seed)
    q, k, v, do = S._flash_inputs(torch, gen, S.GPT2_SHAPE, torch.bfloat16)
    gpt2 = S._flash_errors(torch, F, q, k, v, do, 0.125, True, None,
                           S.DROP_P, seed, repeat=True)
    b, s = S.BERT_BATCH, S.BERT_SEQ
    q, k, v, do = S._flash_inputs(torch, gen, (b, s, 12, 64),
                                  torch.bfloat16)
    keep, _ = S._keypad(torch, np, s)
    bf16 = S._flash_errors(torch, F, q, k, v, do, 0.125, False,
                           F.attn_bias(keep.expand(b, 1, s, s), q, k),
                           S.DROP_P, seed, repeat=True)
    q, k, v, do = S._flash_inputs(torch, gen, (b, s, 12, 64), torch.float32)
    fp32_bert = S.flash_fp32_errors(torch, F, q, k, v, do, 0.125, False,
                                    F.attn_bias(keep.expand(b, 1, s, s), q,
                                                k), S.DROP_P, seed)
    check = {"fp32_gpt2": fp32, "bf16_gpt2": gpt2, "bf16_bert_keypad": bf16,
             "fp32_bert_keypad": fp32_bert,
             "failures": fp32["failures"] + gpt2["failures"]
             + bf16["failures"] + fp32_bert["failures"]}
    del q, k, v, do
    torch.cuda.empty_cache()
    parity = {"failures": []}
    for (arm, model, cls, args, n_inputs, loss_of, _, mode, _,
         _) in S.dropout_bf16_arms(torch, np, GPTConfig, GPTForCausalLM,
                                   BertConfig, BertForPreTraining):
        opt = AdamW(learning_rate=S.TRAIN_LR, parameters=model)
        step = TrainStep(model, opt, loss_of(model), n_inputs=n_inputs)
        for _ in range(S.DROP_BF16_STEPS):
            step(*args)
        parity[arm] = S.dropout_bf16_parity_run(
            torch, K, model, opt, TrainStep, cls, args, n_inputs, loss_of,
            S.DROP_BF16_PARITY[arm], tuple(f"flash_{k_}{mode}"
                                           for k_ in ("fwd", "dq", "dkv")))
        parity[arm].pop("grad_rel_l2")
        parity["failures"] += [f"{arm}: {f}"
                               for f in parity[arm]["failures"]]
        del model, opt, step
        torch.cuda.empty_cache()
    return check, parity


def _varlen_checks(torch, S, K, TrainStep, AdamW) -> tuple:
    import paddle_tpu_torch.incubate.nn.functional as TI
    import paddle_tpu_torch.nn.functional as TF
    from paddle_tpu_torch import io as PIO
    from paddle_tpu_torch.ops.kernels import flash_attention as F
    gen = torch.Generator(device="cuda").manual_seed(S.SEED + 14)
    _, cu = S.varlen_pack(np, PIO, S.varlen_documents(np))
    seg, _ = S.varlen_seg(np, F, cu, cu)
    h, d = S.VARLEN_BF16
    check = {"failures": []}
    for name, causal in (("bf16_causal", True), ("bf16_noncausal", False)):
        q, k, v, do = S._flash_inputs(torch, gen, (1, int(cu[-1]), h, d),
                                      torch.bfloat16)
        check[name] = S._flash_errors(torch, F, q, k, v, do, d ** -0.5,
                                      causal, seg=seg)
        check["failures"] += check[name]["failures"]
        del q, k, v, do
        torch.cuda.empty_cache()
    try:
        parity = S.phase_varlen_packed(torch, np, K, F, PIO, TF, TI)
    except AssertionError as e:    # the phase's own failures, reported
        parity = {"failures": [str(e)[:2000]]}
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
              "paged": _paged_checks, "bert": _bert_checks,
              "fp32": _fp32_checks, "dropout": _dropout_checks,
              "varlen": _varlen_checks, "moe_fp32": _moe_fp32_checks}
    for kind in kinds:
        check, parity = checks[kind](torch, S, K, TrainStep, AdamW)
        grads = parity.pop("grad_rel_l2", None)
        if grads is not None:
            parity["top_grad_rel_l2"] = sorted(grads.items(),
                                               key=lambda kv: -kv[1])[:5]
        out[kind] = check
        out[kind + {"paged": "_slice_parity", "varlen": "_per_doc_parity"}
            .get(kind, "_train_parity")] = parity
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
    sys.path.insert(0, HERE)
    from paddle_tpu_torch.ops.kernels import build
    build.build_all()                       # the copies reuse these
    results = {}
    for name in names:
        root = _copy(name)
        try:
            proc = subprocess.run(
                [sys.executable, os.path.join(root, "chip_mutants.py"),
                 "--child", name, "--kinds", ",".join(kinds)], cwd=root,
                capture_output=True, text=True, timeout=1200)
        except subprocess.TimeoutExpired:
            # a fault that hangs the kernel: the child is killed, the
            # run goes on to the next fault
            proc = subprocess.CompletedProcess([], "timeout", "", "")
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
