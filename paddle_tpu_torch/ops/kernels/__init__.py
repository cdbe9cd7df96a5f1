"""Hand-written CUDA kernels of the port, each beside its plain version.

| kernel | wrapper | replaces (JAX package) |
| --- | --- | --- |
| RMSNorm | ``rms_norm.rms_norm_cuda`` | ``ops/pallas/fused_norm.py::_rms_fwd_pallas`` |
| paged decode | ``paged_attention.paged_attention_cuda`` | ``ops/pallas/paged_attention.py::paged_attention_tpu`` |
| flash forward | ``flash_attention.flash_fwd_cuda`` | ``ops/pallas/flash_attention.py::_fwd`` |
| flash dQ | ``flash_attention.flash_bwd_dq_cuda`` | ``ops/pallas/flash_attention.py::flash_block_grads`` (dQ pass) |
| flash dK/dV | ``flash_attention.flash_bwd_dkv_cuda`` | ``ops/pallas/flash_attention.py::flash_block_grads`` (dK/dV pass) |

The public flash functions (``flash_attention``, ``flash_attention_with_lse``,
``flash_block_grads``) live in the ``flash_attention`` module.
"""

from .flash_attention import (flash_block_grads_plain, flash_bwd_dkv_cuda,
                              flash_bwd_dq_cuda, flash_delta, flash_fwd_cuda,
                              flash_fwd_plain)
from .paged_attention import paged_attention_cuda, paged_attention_plain
from .rms_norm import rms_norm, rms_norm_cuda, rms_norm_plain
from .routing import plain_reference, use_kernel

__all__ = ["rms_norm", "rms_norm_cuda", "rms_norm_plain",
           "paged_attention_cuda", "paged_attention_plain",
           "flash_fwd_plain", "flash_block_grads_plain",
           "flash_fwd_cuda", "flash_bwd_dq_cuda", "flash_bwd_dkv_cuda",
           "flash_delta", "plain_reference", "use_kernel", "launch_counts",
           "reset_launch_counts"]

_WRAPPERS = {"rms_norm": rms_norm_cuda, "paged_attention": paged_attention_cuda,
             "flash_fwd": flash_fwd_cuda, "flash_dq": flash_bwd_dq_cuda,
             "flash_dkv": flash_bwd_dkv_cuda}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0
