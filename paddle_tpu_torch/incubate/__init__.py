"""Incubating APIs of the port (counterpart: paddle_tpu/incubate); only
``nn.functional.variable_length_memory_efficient_attention`` so far."""

from . import nn

__all__ = ["nn"]
