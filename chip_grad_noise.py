#!/usr/bin/env python3
"""How far bf16 alone moves BERT-Base's gradients, layer by layer.

    python3 chip_grad_noise.py [--seeds 1 2]

On one GPU, for each seed: ``chip_smoke.py``'s ``bench_bert``
configuration (BERT-Base at full width and depth, bf16) with weights
drawn from the seed, and a padded 32 x 512 pretraining batch as
``train_bert_padded`` builds it (ids, labels and token-type splits drawn
from the seed). One step's gradients through the plain versions in bf16
are held against those of an fp32 copy of the same weights
(``fp32_grads``): per parameter, the relative L2 distance
(``bf16_noise``). Prints, per seed, the readings of each layer's
attention projections, the parameters above half of
``BERT_PARITY``'s gradient limit (those ``train_parity_run`` holds to
the fp32 gradient instead of the plain bf16 one), and the largest
reading among the rest; then the card, and one JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2])
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_grad_noise: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as S
    from paddle_tpu_torch.models import BertConfig, BertForPreTraining
    from paddle_tpu_torch.ops import kernels as K
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"device: {S._nvidia_smi()}", flush=True)
    limit = S.BERT_PARITY[1] / 2
    for seed in args.seeds:
        cfg = S.bert_config(BertConfig)
        model = BertForPreTraining(cfg, device="cuda", seed=seed)
        batch, n_inputs = S.bert_batch(torch, np, cfg, padded=True,
                                       seed=seed)
        ref = S.fp32_grads(torch, K, model, BertForPreTraining, batch,
                           n_inputs, S._bert_loss)
        with K.plain_reference():
            out = model(*batch[:n_inputs])
            S._bert_loss(model)(out, *batch[n_inputs:]).backward()
        noise = {k: ((p.grad.float() - ref[k]).norm()
                     / ref[k].norm().clamp(min=1e-30)).item()
                 for k, p in model.named_parameters()}
        by_layer = S.bert_noise_by_layer(noise, cfg.num_hidden_layers)
        print(f"seed {seed}: relative L2 of the bf16 gradient from fp32")
        print("layer  q_proj  k_proj  v_proj  out_proj")
        for i, row in by_layer.items():
            print(f"{i:5d}  " + "  ".join(f"{row[side]:.4g}" for side in (
                "q_proj", "k_proj", "v_proj", "out_proj")))
        above = sorted(k for k, v in noise.items() if v > limit)
        rest = max((v, k) for k, v in noise.items() if v <= limit)
        print(f"above {limit}: {len(above)} of {len(noise)}: {above}")
        print(f"largest below: {rest}", flush=True)
        print(json.dumps({"seed": seed, "by_layer": by_layer,
                          "above": above, "largest_below": rest}),
              flush=True)
        del model, ref, out
        torch.cuda.empty_cache()
    print(f"nvidia-smi: {S._nvidia_smi()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
