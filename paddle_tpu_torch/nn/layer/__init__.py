from .common import Dropout, Embedding, Linear, set_generator
from .norm import LayerNorm, RMSNorm
from .transformer import (MultiHeadAttention, TransformerEncoder,
                          TransformerEncoderLayer)

__all__ = ["Dropout", "Embedding", "Linear", "LayerNorm", "RMSNorm",
           "MultiHeadAttention", "TransformerEncoder",
           "TransformerEncoderLayer", "set_generator"]
