"""Hand-written CUDA kernels of the port, each beside its plain version.

| kernel | wrapper | replaces (JAX package) |
| --- | --- | --- |
| RMSNorm | ``rms_norm.rms_norm_cuda`` | ``ops/pallas/fused_norm.py::_rms_fwd_pallas`` |
| paged decode | ``paged_attention.paged_attention_cuda`` | ``ops/pallas/paged_attention.py::paged_attention_tpu`` (fp mode) |
| paged decode, int8 | ``paged_attention.paged_attention_cuda`` with scales | ``ops/pallas/paged_attention.py::paged_attention_tpu`` (``k_scale``/``v_scale``) |
| flash forward | ``flash_attention.flash_fwd_cuda`` | ``ops/pallas/flash_attention.py::_fwd`` |
| flash dQ | ``flash_attention.flash_bwd_dq_cuda`` | ``ops/pallas/flash_attention.py::flash_block_grads`` (dQ pass) |
| flash dK/dV | ``flash_attention.flash_bwd_dkv_cuda`` | ``ops/pallas/flash_attention.py::flash_block_grads`` (dK/dV pass) |
| MoE top-2 routing | ``moe_routing.moe_routing_cuda`` | ``ops/pallas/moe_routing.py::_run_kernel`` |
| MoE grouped forward | ``moe_grouped_gemm.moe_fwd_cuda`` | ``ops/pallas/moe_grouped_gemm.py::_fwd_call`` |
| MoE grouped dX | ``moe_grouped_gemm.moe_dx_cuda`` | ``ops/pallas/moe_grouped_gemm.py::_dx_call`` |
| MoE grouped dW | ``moe_grouped_gemm.moe_dw_cuda`` | ``ops/pallas/moe_grouped_gemm.py::_dw_call`` |
| MoE grouped forward, dX, dW in fp32 | the same wrappers on fp32 tensors | the same ``pallas_call``s on fp32 inputs |
| LayerNorm | ``layer_norm.layer_norm_cuda`` | ``ops/pallas/fused_norm.py::_ln_fwd_pallas`` |

Each flash kernel has ten modes: bf16 or fp32 inputs, with or without
in-kernel dropout (``dropout_p`` and its key ``seed_arr``, ``_flash_drop``),
with or without an additive bias (``has_bias``), and the segment-id mode
of packed sequences (``has_seg``, ``flash_attn_unpadded``), which takes
neither a bias nor dropout.

The public flash functions (``flash_attention``, ``flash_attention_with_lse``,
``flash_block_grads``, ``flash_attn_unpadded``) live in the
``flash_attention`` module; the
differentiable MoE functions (``fused_top2_routing``,
``fused_grouped_moe``) in their modules. :func:`launch_counts` reports
each kernel by name; the paged kernel's two modes count apart
(``paged_attention``, ``paged_attention_int8``), and so do the flash
kernels' ten (``flash_fwd``, ``flash_fwd_bias``, ``flash_fwd_drop``,
``flash_fwd_drop_bias``, ``flash_fwd_fp32``, ..., ``flash_fwd_fp32_drop_bias``,
``flash_fwd_seg``, ``flash_fwd_fp32_seg``, and the same for ``flash_dq``
and ``flash_dkv``), and the grouped-GEMM kernels' two (``moe_fwd`` and
``moe_fwd_fp32``, and the same for ``moe_dx`` and ``moe_dw``), so a run
shows which mode its path took.
"""

from .flash_attention import (MODES, flash_block_grads_plain,
                              flash_bwd_dkv_cuda, flash_bwd_dq_cuda,
                              flash_delta, flash_fwd_cuda, flash_fwd_plain,
                              mode_attr)
from .layer_norm import layer_norm, layer_norm_cuda, layer_norm_plain
from .moe_grouped_gemm import (moe_dw_cuda, moe_dw_plain, moe_dx_cuda,
                               moe_dx_plain, moe_fwd_cuda, moe_fwd_plain)
from .moe_routing import moe_routing_cuda, routing_plain
from .paged_attention import paged_attention_cuda, paged_attention_plain
from .rms_norm import rms_norm, rms_norm_cuda, rms_norm_plain
from .routing import plain_reference, use_kernel

__all__ = ["rms_norm", "rms_norm_cuda", "rms_norm_plain",
           "paged_attention_cuda", "paged_attention_plain",
           "flash_fwd_plain", "flash_block_grads_plain",
           "flash_fwd_cuda", "flash_bwd_dq_cuda", "flash_bwd_dkv_cuda",
           "flash_delta", "moe_routing_cuda", "routing_plain",
           "moe_fwd_cuda", "moe_dx_cuda", "moe_dw_cuda", "moe_fwd_plain",
           "moe_dx_plain", "moe_dw_plain", "layer_norm", "layer_norm_cuda",
           "layer_norm_plain", "plain_reference", "use_kernel",
           "launch_counts", "reset_launch_counts"]

# kernel name -> (wrapper, the wrapper's attribute that counts it)
_COUNTERS = {
    "rms_norm": (rms_norm_cuda, "launches"),
    "paged_attention": (paged_attention_cuda, "launches"),
    "paged_attention_int8": (paged_attention_cuda, "int8_launches"),
    **{"flash_" + kind + "_fp32" * f + "_drop" * d + "_bias" * b
       + "_seg" * sg: (fn, mode_attr(f, d, b, sg))
       for (f, d, b, sg) in MODES
       for kind, fn in (("fwd", flash_fwd_cuda), ("dq", flash_bwd_dq_cuda),
                        ("dkv", flash_bwd_dkv_cuda))},
    "moe_routing": (moe_routing_cuda, "launches"),
    "moe_fwd": (moe_fwd_cuda, "launches"),
    "moe_dx": (moe_dx_cuda, "launches"),
    "moe_dw": (moe_dw_cuda, "launches"),
    "moe_fwd_fp32": (moe_fwd_cuda, "fp32_launches"),
    "moe_dx_fp32": (moe_dx_cuda, "fp32_launches"),
    "moe_dw_fp32": (moe_dw_cuda, "fp32_launches"),
    "layer_norm": (layer_norm_cuda, "launches")}


def launch_counts() -> dict[str, int]:
    return {name: getattr(fn, attr) for name, (fn, attr) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for fn, attr in _COUNTERS.values():
        setattr(fn, attr, 0)
