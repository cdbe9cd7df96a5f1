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

The public flash functions (``flash_attention``, ``flash_attention_with_lse``,
``flash_block_grads``) live in the ``flash_attention`` module; the
differentiable MoE functions (``fused_top2_routing``,
``fused_grouped_moe``) in their modules. :func:`launch_counts` reports
each kernel by name; the paged kernel's two modes count apart
(``paged_attention``, ``paged_attention_int8``), so a run shows which
mode its path took.
"""

from .flash_attention import (flash_block_grads_plain, flash_bwd_dkv_cuda,
                              flash_bwd_dq_cuda, flash_delta, flash_fwd_cuda,
                              flash_fwd_plain)
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
           "moe_dx_plain", "moe_dw_plain", "plain_reference", "use_kernel",
           "launch_counts", "reset_launch_counts"]

# kernel name -> (wrapper, the wrapper's attribute that counts it)
_COUNTERS = {
    "rms_norm": (rms_norm_cuda, "launches"),
    "paged_attention": (paged_attention_cuda, "launches"),
    "paged_attention_int8": (paged_attention_cuda, "int8_launches"),
    "flash_fwd": (flash_fwd_cuda, "launches"),
    "flash_dq": (flash_bwd_dq_cuda, "launches"),
    "flash_dkv": (flash_bwd_dkv_cuda, "launches"),
    "moe_routing": (moe_routing_cuda, "launches"),
    "moe_fwd": (moe_fwd_cuda, "launches"),
    "moe_dx": (moe_dx_cuda, "launches"),
    "moe_dw": (moe_dw_cuda, "launches")}


def launch_counts() -> dict[str, int]:
    return {name: getattr(fn, attr) for name, (fn, attr) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for fn, attr in _COUNTERS.values():
        setattr(fn, attr, 0)
