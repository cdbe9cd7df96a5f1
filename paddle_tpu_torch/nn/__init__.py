"""The nn subset the Llama, Qwen2-MoE, BERT and GPT models need
(counterpart: paddle_tpu/nn)."""

from . import functional
from .functional import silu
from .layer import (Dropout, Embedding, LayerNorm, Linear, MultiHeadAttention,
                    RMSNorm, TransformerEncoder, TransformerEncoderLayer)

__all__ = ["functional", "silu", "Dropout", "Embedding", "LayerNorm",
           "Linear", "MultiHeadAttention", "RMSNorm", "TransformerEncoder",
           "TransformerEncoderLayer"]
