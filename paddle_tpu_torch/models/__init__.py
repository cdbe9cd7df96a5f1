from .llama import (LlamaConfig, LlamaForCausalLM, apply_rotary_pos_emb,
                    llama_3_8b, llama_tiny)
from .weights import (export_numpy_state, init_random, load_numpy_state,
                      load_optimizer_state)

__all__ = ["LlamaConfig", "LlamaForCausalLM", "apply_rotary_pos_emb",
           "llama_3_8b", "llama_tiny", "init_random", "load_numpy_state",
           "export_numpy_state", "load_optimizer_state"]
