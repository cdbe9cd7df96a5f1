"""BERT (counterpart: paddle_tpu/models/bert.py).

Same configuration fields, parameter names and Paddle weight layout as
the JAX model, so a JAX ``state_dict`` loads unchanged
(``models/weights.py``). The encoder is post-norm
``TransformerEncoderLayer``s with exact-erf GELU; LayerNorm takes the
hand-written kernel on the card, and attention from 256 query rows on
takes flash attention, a padding mask in the kernels' bias mode. The MLM
logits go through the tied word embedding, one parameter that receives
the gradient of both the lookup and the product.

Dropout (``hidden_dropout_prob`` on the embeddings, the residual
branches and the FFN activation, ``attention_probs_dropout_prob`` on the
probabilities, in the flash kernels' dropout mode from 256 rows on)
draws from the model's ``generator``, seeded from ``seed`` and shared by
every Dropout and attention layer, so BERT's own defaults (fp32, both
dropouts 0.1) train reproducibly from a seed. The bits are not
``jax.random``'s (ROADMAP.md A1). ``bench.py::bench_bert`` trains with
both dropouts at 0.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..core import resolve_device, resolve_dtype
from ..nn import functional as F
from ..nn.layer import (Dropout, Embedding, LayerNorm, Linear,
                        TransformerEncoder, TransformerEncoderLayer,
                        set_generator)

__all__ = ["BertConfig", "BertEmbeddings", "BertModel", "BertForPreTraining",
           "BertForSequenceClassification", "bert_base", "bert_large"]


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dtype: str = "float32"


class BertEmbeddings(nn.Module):
    """Word + position (+ token type) embeddings, LayerNorm, dropout
    (counterpart: bert.py:35-54)."""

    def __init__(self, config: BertConfig, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.word_embeddings = Embedding(config.vocab_size,
                                         config.hidden_size, **kw)
        self.position_embeddings = Embedding(config.max_position_embeddings,
                                             config.hidden_size, **kw)
        self.token_type_embeddings = Embedding(config.type_vocab_size,
                                               config.hidden_size, **kw)
        self.layer_norm = LayerNorm(config.hidden_size,
                                    epsilon=config.layer_norm_eps, **kw)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None):
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)[None, :]
        x = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        if token_type_ids is not None:
            x = x + self.token_type_embeddings(token_type_ids)
        return self.dropout(self.layer_norm(x))


class BertModel(nn.Module):
    """Embeddings, the encoder and the tanh pooler over the first token
    (counterpart: bert.py:57-83)."""

    def __init__(self, config: BertConfig, device, dtype):
        super().__init__()
        self.config = config
        self.embeddings = BertEmbeddings(config, device, dtype)
        layer = TransformerEncoderLayer(
            config.hidden_size, config.num_attention_heads,
            config.intermediate_size, dropout=config.hidden_dropout_prob,
            activation=config.hidden_act,
            attn_dropout=config.attention_probs_dropout_prob,
            layer_norm_eps=config.layer_norm_eps, device=device, dtype=dtype)
        self.encoder = TransformerEncoder(layer, config.num_hidden_layers)
        self.pooler_dense = Linear(config.hidden_size, config.hidden_size,
                                   device=device, dtype=dtype)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        x = self.embeddings(input_ids, token_type_ids)
        if attention_mask is not None and attention_mask.dim() == 2:
            # [b, s] validity -> bool [b, 1, 1, s] (bert.py:73-79): a bool
            # mask carries no gradient, so attention keeps the flash
            # kernels (their bias mode)
            attention_mask = attention_mask[:, None, None, :] > 0
        x = self.encoder(x, attention_mask)
        pooled = F.tanh(self.pooler_dense(x[:, 0]))
        return x, pooled


def _model_args(config, device):
    return resolve_device(device), resolve_dtype(config.dtype)


def _init(model, seed):
    """The model's generator (seeded from ``seed``, or 0) on every layer
    that draws, then seeded random weights unless ``seed`` is None."""
    device = next(model.parameters()).device
    model.generator = torch.Generator(device=device)
    model.generator.manual_seed(0 if seed is None else int(seed))
    set_generator(model, model.generator)
    if seed is not None:
        from .weights import init_random
        init_random(model, seed)


class BertForPreTraining(nn.Module):
    """``BertForPreTraining(config, device=None, seed=0)``: MLM logits
    through the tied word embedding and NSP logits (counterpart:
    bert.py:86-109). ``device=None`` means the GPU (RuntimeError without
    one — pass ``device="cpu"`` for the CPU); ``seed=None`` leaves the
    weights uninitialised for a load from the JAX model. ``generator``
    (seeded from ``seed``, or 0) draws every dropout mask and
    attention-dropout key."""

    def __init__(self, config: BertConfig, device=None, seed: int | None = 0):
        super().__init__()
        device, dtype = _model_args(config, device)
        kw = dict(device=device, dtype=dtype)
        self.bert = BertModel(config, device, dtype)
        self.mlm_transform = Linear(config.hidden_size, config.hidden_size,
                                    **kw)
        self.mlm_norm = LayerNorm(config.hidden_size, **kw)   # eps 1e-5
        self.nsp_head = Linear(config.hidden_size, 2, **kw)
        self.config = config
        _init(self, seed)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        seq, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        h = self.mlm_norm(F.gelu(self.mlm_transform(seq)))
        mlm_logits = h @ self.bert.embeddings.word_embeddings.weight.T
        nsp_logits = self.nsp_head(pooled)
        return mlm_logits, nsp_logits

    def loss(self, mlm_logits, nsp_logits, mlm_labels, nsp_labels):
        """MLM cross entropy (labels -100 ignored) plus NSP cross entropy
        (counterpart: bert.py:104-109)."""
        mlm = F.cross_entropy(mlm_logits.reshape(-1, mlm_logits.shape[-1]),
                              mlm_labels.reshape(-1), ignore_index=-100)
        nsp = F.cross_entropy(nsp_logits, nsp_labels)
        return mlm + nsp

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())


class BertForSequenceClassification(nn.Module):
    """Pooled output, dropout, a linear classifier (counterpart:
    bert.py:112-122)."""

    def __init__(self, config: BertConfig, num_classes: int = 2,
                 device=None, seed: int | None = 0):
        super().__init__()
        device, dtype = _model_args(config, device)
        self.bert = BertModel(config, device, dtype)
        self.dropout = Dropout(config.hidden_dropout_prob)
        self.classifier = Linear(config.hidden_size, num_classes,
                                 device=device, dtype=dtype)
        self.config = config
        _init(self, seed)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        return self.classifier(self.dropout(pooled))


def bert_base(**kw) -> BertConfig:
    """BERT-Base widths (counterpart: bert.py:125)."""
    return BertConfig(**kw)


def bert_large(**kw) -> BertConfig:
    """BERT-Large widths (counterpart: bert.py:129)."""
    return BertConfig(hidden_size=1024, num_hidden_layers=24,
                      num_attention_heads=16, intermediate_size=4096, **kw)
