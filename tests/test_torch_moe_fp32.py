"""The fp32 Qwen2-MoE slice's configuration, on the CPU.

``chip_smoke.py``'s ``train_moe_fp32`` phases train
``moe_fp32_config``: ``bench.py::bench_qwen2_moe``'s ``qwen2_moe_fused``
configuration (``moe_config``) in fp32, with the expert width cut from
704 to ``MOE_FP32_H`` = 512, the width at which the JAX package's fused
gate admits fp32 at these shapes (its VMEM term rejects 704). These
tests pin that: the two configurations differ in those two fields only,
and at the phase's token count both packages' gates admit the fp32
configuration, so on the card its MoE layers take the fused dispatch and
with it the fp32 grouped-GEMM kernels.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import torch

import paddle_tpu.nn.functional as JF
from paddle_tpu.ops.pallas import moe_grouped_gemm as jax_gg
from paddle_tpu_torch.distributed.moe import TopKGate
from paddle_tpu_torch.models import Qwen2MoeConfig
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.kernels import moe_grouped_gemm as gg
from torch_one_thread import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fp32_config_is_the_fused_config_at_the_fp32_expert_width():
    S = _smoke()
    base = S.moe_config(Qwen2MoeConfig, S.MOE_SEQ).__dict__
    cfg = S.moe_fp32_config(Qwen2MoeConfig, S.MOE_SEQ).__dict__
    assert set(base) == set(cfg)
    assert {k for k in base if base[k] != cfg[k]} == {
        "dtype", "moe_intermediate_size"}
    assert cfg["dtype"] == "float32" and base["dtype"] == "bfloat16"
    assert (cfg["moe_intermediate_size"], base["moe_intermediate_size"]) \
        == (S.MOE_FP32_H, 704)


def test_both_gates_admit_the_fp32_config_and_reject_its_uncut_width():
    S = _smoke()
    cfg = S.moe_fp32_config(Qwen2MoeConfig, S.MOE_SEQ)
    T, D, E = S.MOE_BATCH * S.MOE_SEQ, cfg.hidden_size, cfg.num_experts
    cap = TopKGate(D, E, top_k=cfg.num_experts_per_tok,
                   device="cpu").capacity(T)
    assert cap == 1280
    for H, admitted in ((cfg.moe_intermediate_size, True), (704, False)):
        assert jax_gg.fused_dispatch_applicable(
            T, D, H, E, cap, jnp.float32, JF.silu, True) == admitted
        assert gg.fused_dispatch_applicable(
            T, D, H, E, cap, torch.float32, F.silu, True) == admitted
