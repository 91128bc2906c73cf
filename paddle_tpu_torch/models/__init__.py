"""Model families of the port."""

from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel,  # noqa: F401
                    llama2_7b, llama2_13b, llama2_70b, llama_tiny)
from .gpt import (GPTConfig, GPTForCausalLM, GPTModel, gpt2_small,  # noqa: F401
                  gpt3_1p3b, gpt_tiny)
