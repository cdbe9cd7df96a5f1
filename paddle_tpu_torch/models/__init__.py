from .bert import (BertConfig, BertForPreTraining,
                   BertForSequenceClassification, BertModel, bert_base,
                   bert_large)
from .gpt import (GPTConfig, GPTForCausalLM, GPTModel, gpt2_medium,
                  gpt2_small)
from .llama import (LlamaConfig, LlamaForCausalLM, apply_rotary_pos_emb,
                    llama_3_8b, llama_tiny)
from .qwen2_moe import Qwen2MoeConfig, Qwen2MoeForCausalLM, qwen2_moe_tiny
from .weights import (export_numpy_state, init_random, load_numpy_state,
                      load_optimizer_state)

__all__ = ["BertConfig", "BertForPreTraining",
           "BertForSequenceClassification", "BertModel", "bert_base",
           "bert_large", "GPTConfig", "GPTForCausalLM", "GPTModel",
           "gpt2_medium", "gpt2_small", "LlamaConfig", "LlamaForCausalLM",
           "apply_rotary_pos_emb", "llama_3_8b", "llama_tiny",
           "Qwen2MoeConfig",
           "Qwen2MoeForCausalLM", "qwen2_moe_tiny", "init_random",
           "load_numpy_state", "export_numpy_state", "load_optimizer_state"]
