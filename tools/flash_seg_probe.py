#!/usr/bin/env python3
"""A short first call for the flash kernels' segment-id mode on a GPU:
build the two flash sources (``ptxas``'s registers and spills per
instantiation go to the file ``--report`` names), hold the
segment mode of the forward, dQ and dK/dV against the plain versions in
fp64 at small ragged shapes (sorted ids with a one-token segment,
unsorted ids, a key segment with no keys; bf16 and fp32, d 64 and 128,
causal and not; the plain fp32 versions' own error beside it), and time
the segment mode at the packed batch of ``bench.py::bench_llama``'s
first host step ([8760, 16, 128] bf16, 8 documents, causal) beside the
no-segment kernels at the Llama training shape [4, 2048, 16, 128]
causal (CUDA events, 20 calls).

    python3 tools/flash_seg_probe.py [--tree PATH] [--times] [--report FILE]

``--tree`` takes the kernels of another checkout (built into its own
``build/kernels``), ``--times`` runs the timings alone, so that two
versions can be compared in turns in one call. The timings also run the
segment mode with one id for every token, non-causal, beside the
no-segment kernel on the same inputs (the cost of the segment machinery
where no tile is skipped and no element tested).

The fp32 rule's rows (``tests/test_torch_cuda.py::_fp32_rule``) are the
segment cases with 1-token and 32-token segments, and a key-padding
bias that leaves the rows of one batch element one key (fp32, d 128,
non-causal): a row that sees one key has dS = P (dP - delta) = 0 in
exact arithmetic, so its dq, and its key's dk, are the rounding of dP
alone.

The full checks, with their limits, are ``chip_smoke.py``'s
``flash_varlen`` and ``varlen_packed`` phases.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PACKED = (1762, 1490, 825, 1537, 558, 463, 297, 1828)


def _err(got, want):
    d = got.double() - want.double()
    rowmax = want.double().abs().amax(-1).clamp(min=1e-30)
    return {"max": d.abs().max().item(),
            "row": (d.abs().amax(-1) / (rowmax + 1e-3)).max().item(),
            "fro": (d.norm() / want.double().norm().clamp(min=1e-30))
            .item()}


def _ids(lens):
    return np.repeat(np.arange(len(lens)), lens)


def _ms(fn, n=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--times", action="store_true")
    ap.add_argument("--report", default=os.path.join(
        ROOT, "build", "flash_seg_probe_ptxas.txt"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_seg_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.tree))
    from paddle_tpu_torch.ops.kernels import build
    from paddle_tpu_torch.ops.kernels import flash_attention as F
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    out = build.build_all(["flash_attention_fwd", "flash_attention_bwd"])
    print("build s", time.time() - t0, flush=True)
    if any(b["built"] for b in out.values()):
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, "w") as fh:
            for name, b in out.items():
                fh.write(f"--- {name}\n{b['log']}\n")
    gen = torch.Generator(device="cuda").manual_seed(0)
    if not args.times:
        _checks(F, gen)
    _timings(F, gen, args.tree)
    return 0


def _checks(F, gen):
    cases = [  # (name, ids_q, ids_k, b, h, d, causal, dtype)
        ("sorted_causal_bf16_d128", _ids((100, 37, 250, 1, 90)),
         _ids((100, 37, 250, 1, 90)), 1, 2, 128, True, torch.bfloat16),
        ("sorted_causal_fp32_d64", _ids((100, 37, 250, 1, 90)),
         _ids((100, 37, 250, 1, 90)), 1, 3, 64, True, torch.float32),
        ("unsorted_bf16_d64", (np.arange(300) // 50) % 3,
         (np.arange(260) // 70) % 3, 2, 2, 64, False, torch.bfloat16),
        ("unsorted_causal_fp32_d128", (np.arange(333) // 40) % 4,
         (np.arange(333) // 40) % 4, 1, 2, 128, True, torch.float32),
        ("cross_empty_key_bf16_d128", _ids((120, 64, 200, 33)),
         _ids((90, 0, 150, 70)), 1, 2, 128, False, torch.bfloat16),
        ("cross_empty_key_fp32_d64", _ids((120, 64, 200, 33)),
         _ids((90, 0, 150, 70)), 1, 2, 64, False, torch.float32),
    ]
    for name, iq, ik, b, h, d, causal, dt in cases:
        sq, sk = len(iq), len(ik)
        q, do = (torch.randn((b, sq, h, d), generator=gen,
                             device="cuda").to(dt) for _ in range(2))
        k, v = (torch.randn((b, sk, h, d), generator=gen,
                            device="cuda").to(dt) for _ in range(2))
        seg = F.seg_ids(iq, ik, "cuda")
        sc = d ** -0.5
        q64, k64, v64, do64 = (x.double() for x in (q, k, v, do))
        ro, rl = F.flash_fwd_plain(q64, k64, v64, sc, causal, seg=seg)
        rg = F.flash_block_grads_plain(q64, k64, v64, do64, rl,
                                       F.flash_delta(do64, ro), sc, causal,
                                       seg=seg)
        po, _ = F.flash_fwd_plain(q.float(), k.float(), v.float(), sc,
                                  causal, seg=seg)
        ko, kl = F.flash_fwd_cuda(q, k, v, sc, causal, seg=seg)
        delta = F.flash_delta(do, ro.float().to(dt))
        lse = rl.float()
        pg = F.flash_block_grads_plain(q.float(), k.float(), v.float(),
                                       do.float(), lse, delta, sc, causal,
                                       seg=seg)
        kg = (F.flash_bwd_dq_cuda(q, k, v, do, lse, delta, sc, causal,
                                  seg=seg),) + F.flash_bwd_dkv_cuda(
            q, k, v, do, lse, delta, sc, causal, seg=seg)
        torch.cuda.synchronize()
        dead = rl <= -1e29
        res = {"case": name, "dead_rows": int(dead.sum()),
               "dead_equal": bool(((kl <= -1e29) == dead).all()),
               "dead_out_zero": bool((ko.transpose(1, 2)[dead] == 0).all()),
               "lse": (kl.double() - rl)[~dead].abs().max().item()}
        for o, kk, pp, rr in zip(("out", "dq", "dk", "dv"), (ko,) + kg,
                                 (po,) + pg, (ro,) + rg):
            res[o] = {"kernel": _err(kk, rr), "plain": _err(pp, rr)}
        print(json.dumps(res), flush=True)
    _rule_rows(F)
    ids = _ids(PACKED)
    n, h, d = len(ids), 16, 128
    seg = F.seg_ids(ids, ids, "cuda")
    q, k, v, do = (torch.randn((1, n, h, d), generator=gen,
                               device="cuda").bfloat16() for _ in range(4))
    o, lse = F.flash_fwd_cuda(q, k, v, 0.125, True, seg=seg)
    po, pl = F.flash_fwd_plain(q.float(), k.float(), v.float(), 0.125, True,
                               seg=seg)
    torch.cuda.synchronize()
    print(json.dumps({"packed_fwd_vs_plain": _err(o, po),
                      "lse": (lse - pl).abs().max().item()}), flush=True)


def _rule_rows(F):
    """The fp32 rule (tests/test_torch_cuda.py::_fp32_rule), output by
    output, at its segment cases with 1-token and 32-token segments and
    at a key-padding bias whose batch element 1 keeps one key: the worst
    row's error over its scale (row max + 2**-6 of the output's max),
    the plain fp32 version's, the limit, the worst row's segment length,
    and the relative Frobenius errors with theirs."""
    lens = (64, 64, 63, 65, 1, 127, 32)
    ids = _ids(lens)
    cases = [(f"seg {lens} d {d_} causal {c}", d_, c, len(ids), "seg")
             for d_, c in ((128, False), (64, False), (128, True))]
    cases.append(("keypad (200, 1) d 128 non-causal", 128, False, 200,
                  "keypad"))
    for name, d_, causal, s, kind in cases:
        g = torch.Generator(device="cuda").manual_seed(8)
        q, k, v, do = (torch.randn((2, s, 2, d_), generator=g,
                                   device="cuda") for _ in range(4))
        if kind == "seg":
            mode = {"seg": F.seg_ids(ids, ids, "cuda")}
            rows_len = np.asarray(lens)[ids]
        else:
            n_keys = torch.tensor([s, 1], device="cuda")
            keep = torch.arange(s, device="cuda")[None, :] < n_keys[:, None]
            mode = {"bias": F.attn_bias(keep[:, None, None, :].expand(
                2, 1, s, s), q, k)}
            rows_len = None
        sc = d_ ** -0.5
        q64, k64, v64, do64 = (x.double() for x in (q, k, v, do))
        ro, rl = F.flash_fwd_plain(q64, k64, v64, sc, causal, **mode)
        rd = F.flash_delta(do64, ro)
        rg = F.flash_block_grads_plain(q64, k64, v64, do64, rl, rd, sc,
                                       causal, **mode)
        lse, delta = rl.float(), rd.float()
        po, _ = F.flash_fwd_plain(q, k, v, sc, causal, **mode)
        pg = F.flash_block_grads_plain(q, k, v, do, lse, delta, sc, causal,
                                       **mode)
        ko, _ = F.flash_fwd_cuda(q, k, v, sc, causal, **mode)
        kg = (F.flash_bwd_dq_cuda(q, k, v, do, lse, delta, sc, causal,
                                  **mode),) + F.flash_bwd_dkv_cuda(
            q, k, v, do, lse, delta, sc, causal, **mode)
        torch.cuda.synchronize()
        rows = {}
        for o, kk, pp, rr in zip(("out", "dq", "dk", "dv"), (ko,) + kg,
                                 (po,) + pg, (ro,) + rg):
            scale = rr.abs().amax(-1) + 2 ** -6 * rr.abs().max()
            kr = (kk.double() - rr).abs().amax(-1) / scale
            pr = (pp.double() - rr).abs().amax(-1) / scale
            kf = ((kk.double() - rr).norm() / rr.norm()).item()
            pf = ((pp.double() - rr).norm() / rr.norm()).item()
            bi, t, hi = np.unravel_index(int(kr.argmax()), kr.shape)
            rows[o] = {"kernel": kr.max().item(), "plain": pr.max().item(),
                       "limit": 2 * pr.max().item() + 2 ** -16,
                       "fro": kf, "plain_fro": pf,
                       "fro_limit": 2 * pf + 2 ** -18,
                       "worst_row": [int(bi), int(t), int(hi)],
                       "worst_row_segment_len": None if rows_len is None
                       else int(rows_len[t])}
        print(json.dumps({"fp32_rule_rows": name, **rows}), flush=True)


def _timings(F, gen, tree):
    ids = _ids(PACKED)
    n, h, d = len(ids), 16, 128
    seg = F.seg_ids(ids, ids, "cuda")
    one = F.seg_ids(np.zeros(n, np.int64), np.zeros(n, np.int64), "cuda")
    q, k, v, do = (torch.randn((1, n, h, d), generator=gen,
                               device="cuda").bfloat16() for _ in range(4))
    o, lse = F.flash_fwd_cuda(q, k, v, 0.125, True, seg=seg)
    delta = F.flash_delta(do, o)
    o1, lse1 = F.flash_fwd_cuda(q, k, v, 0.125, False)
    delta1 = F.flash_delta(do, o1)
    times = {
        "seg_fwd": lambda: F.flash_fwd_cuda(q, k, v, 0.125, True, seg=seg),
        "seg_dq": lambda: F.flash_bwd_dq_cuda(q, k, v, do, lse, delta,
                                              0.125, True, seg=seg),
        "seg_dkv": lambda: F.flash_bwd_dkv_cuda(q, k, v, do, lse, delta,
                                                0.125, True, seg=seg),
        "seg_fwd_noncausal": lambda: F.flash_fwd_cuda(q, k, v, 0.125,
                                                      False, seg=seg),
        "global_causal_fwd": lambda: F.flash_fwd_cuda(q, k, v, 0.125,
                                                      True),
        "one_id_fwd": lambda: F.flash_fwd_cuda(q, k, v, 0.125, False,
                                               seg=one),
        "no_seg_fwd": lambda: F.flash_fwd_cuda(q, k, v, 0.125, False),
        "one_id_dq": lambda: F.flash_bwd_dq_cuda(q, k, v, do, lse1, delta1,
                                                 0.125, False, seg=one),
        "no_seg_dq": lambda: F.flash_bwd_dq_cuda(q, k, v, do, lse1, delta1,
                                                 0.125, False),
        "one_id_dkv": lambda: F.flash_bwd_dkv_cuda(q, k, v, do, lse1,
                                                   delta1, 0.125, False,
                                                   seg=one),
        "no_seg_dkv": lambda: F.flash_bwd_dkv_cuda(q, k, v, do, lse1,
                                                   delta1, 0.125, False)}
    res = {name: _ms(fn) for name, fn in times.items()}
    q4, k4, v4, do4 = (torch.randn((4, 2048, h, d), generator=gen,
                                   device="cuda").bfloat16()
                       for _ in range(4))
    o4, l4 = F.flash_fwd_cuda(q4, k4, v4, 0.125, True)
    d4 = F.flash_delta(do4, o4)
    res.update({
        "llama_fwd": _ms(lambda: F.flash_fwd_cuda(q4, k4, v4, 0.125, True)),
        "llama_dq": _ms(lambda: F.flash_bwd_dq_cuda(q4, k4, v4, do4, l4, d4,
                                                    0.125, True)),
        "llama_dkv": _ms(lambda: F.flash_bwd_dkv_cuda(q4, k4, v4, do4, l4,
                                                      d4, 0.125, True))})
    print(json.dumps({"tree": tree, "ms": res}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
