#!/usr/bin/env python3
"""A short first call for the flash kernels' fp32 and dropout modes on a
GPU: build the two flash sources (printing ``ptxas``'s registers and
spills per instantiation), hold each mode against the plain versions in
fp64 at small ragged shapes (and the plain fp32 versions' own error
beside it), check a repeat launch bitwise, and time the fp32 kernels at
GPT-2 small's attention shape [8, 1024, 12, 64] causal, with and
without dropout (CUDA events, 20 calls).

    python3 tools/flash_modes_probe.py

The full checks, with their limits, are ``chip_smoke.py``'s
``flash_fp32`` and ``flash_dropout`` phases.
"""

import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from paddle_tpu_torch.ops.kernels import build  # noqa: E402
from paddle_tpu_torch.ops.kernels import flash_attention as F  # noqa: E402


def _err(got, want):
    d = got.double() - want.double()
    rowmax = want.double().abs().amax(-1).clamp(min=1e-30)
    return {"max": d.abs().max().item(),
            "row": (d.abs().amax(-1) / rowmax).max().item(),
            "fro": (d.norm() / want.double().norm()).item()}


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_modes_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    out = build.build_all(["flash_attention_fwd", "flash_attention_bwd"])
    print("build s", time.time() - t0)
    for name, b in out.items():
        for ln in b["log"].splitlines():
            if "registers" in ln or "spill" in ln or "Compiling" in ln:
                print(name, ln.strip()[:200])
    gen = torch.Generator(device="cuda").manual_seed(0)
    for (b, s, h, d, causal, keypad, p, dt) in [
            (2, 300, 3, 64, True, False, 0.0, torch.float32),
            (2, 256, 2, 128, False, False, 0.0, torch.float32),
            (2, 300, 3, 64, False, True, 0.0, torch.float32),
            (2, 300, 3, 64, True, False, 0.1, torch.float32),
            (2, 256, 2, 128, False, True, 0.1, torch.float32),
            (2, 300, 3, 64, True, False, 0.1, torch.bfloat16),
            (2, 256, 2, 128, False, True, 0.1, torch.bfloat16)]:
        q, k, v, do = (torch.randn((b, s, h, d), generator=gen,
                                   device="cuda").to(dt) for _ in range(4))
        bias = None
        if keypad:
            keep = (torch.arange(s, device="cuda")[None, :]
                    < torch.tensor([s, s - 77], device="cuda")[:, None])
            bias = F.attn_bias(keep[:, None, None, :].expand(b, 1, s, s),
                               q, k)
        seed = torch.tensor([12345, 678], device="cuda") if p else None
        mode = (bias, p, seed)
        sc = d ** -0.5
        q64, k64, v64, do64 = (x.double() for x in (q, k, v, do))
        ro, rl = F.flash_fwd_plain(q64, k64, v64, sc, causal, *mode)
        rg = F.flash_block_grads_plain(q64, k64, v64, do64, rl,
                                       F.flash_delta(do64, ro), sc, causal,
                                       *mode)
        po, _ = F.flash_fwd_plain(q.float(), k.float(), v.float(), sc,
                                  causal, *mode)
        ko, kl = F.flash_fwd_cuda(q, k, v, sc, causal, *mode)
        ko2, _ = F.flash_fwd_cuda(q, k, v, sc, causal, *mode)
        delta = F.flash_delta(do, ro.float().to(dt))
        lse = rl.float()
        pg = F.flash_block_grads_plain(q.float(), k.float(), v.float(),
                                       do.float(), lse, delta, sc, causal,
                                       *mode)
        kg = (F.flash_bwd_dq_cuda(q, k, v, do, lse, delta, sc, causal,
                                  *mode),) + F.flash_bwd_dkv_cuda(
            q, k, v, do, lse, delta, sc, causal, *mode)
        torch.cuda.synchronize()
        res = {"shape": [b, s, h, d, causal, keypad, p, str(dt)],
               "repeat_equal": bool(torch.equal(ko, ko2)),
               "lse": (kl.double() - rl).abs().max().item()}
        for name, kk, pp, rr in zip(("out", "dq", "dk", "dv"),
                                    (ko,) + kg, (po,) + pg, (ro,) + rg):
            res[name] = {"kernel": _err(kk, rr), "plain": _err(pp, rr)}
        print(json.dumps(res))
    b, s, h, d = 8, 1024, 12, 64
    q, k, v, do = (torch.randn((b, s, h, d), generator=gen, device="cuda")
                   for _ in range(4))
    seed = torch.tensor([1, 2], device="cuda")
    o, lse = F.flash_fwd_cuda(q, k, v, 0.125, True, None, 0.1, seed)
    delta = F.flash_delta(do, o)
    for name, fn in (
            ("fwd", lambda: F.flash_fwd_cuda(q, k, v, 0.125, True, None,
                                             0.1, seed)),
            ("dq", lambda: F.flash_bwd_dq_cuda(q, k, v, do, lse, delta,
                                               0.125, True, None, 0.1,
                                               seed)),
            ("dkv", lambda: F.flash_bwd_dkv_cuda(q, k, v, do, lse, delta,
                                                 0.125, True, None, 0.1,
                                                 seed)),
            ("fwd_nodrop", lambda: F.flash_fwd_cuda(q, k, v, 0.125, True)),
            ("dq_nodrop", lambda: F.flash_bwd_dq_cuda(q, k, v, do, lse,
                                                      delta, 0.125, True)),
            ("dkv_nodrop", lambda: F.flash_bwd_dkv_cuda(q, k, v, do, lse,
                                                        delta, 0.125,
                                                        True))):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(20):
            fn()
        e1.record()
        torch.cuda.synchronize()
        print(name, "ms", e0.elapsed_time(e1) / 20)
    return 0


if __name__ == "__main__":
    sys.exit(main())
