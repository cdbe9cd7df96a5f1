"""Counterpart: paddle_tpu/incubate/nn (its functional subset)."""

from . import functional

__all__ = ["functional"]
