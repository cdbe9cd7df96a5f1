"""Distributed pieces of the port (counterpart: paddle_tpu/distributed).
Only the single-device MoE layer is ported (``moe``)."""

from .moe import (ExpertFFN, GShardGate, MoELayer, SwitchGate, TopKGate,
                  moe_fused_compute, moe_grouped_compute)

__all__ = ["ExpertFFN", "GShardGate", "MoELayer", "SwitchGate", "TopKGate",
           "moe_fused_compute", "moe_grouped_compute"]
