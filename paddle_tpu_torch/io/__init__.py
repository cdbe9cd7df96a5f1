"""Input pipeline of the port (counterpart: paddle_tpu/io): the native
sequence packer and row gather."""

from .native_loader import gather_rows, native_available, pack_sequences

__all__ = ["gather_rows", "native_available", "pack_sequences"]
