"""Model families of the port: Llama (MoE included), GPT, ERNIE."""

from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel,  # noqa: F401
                    llama2_7b, llama2_13b, llama2_70b, llama_moe_tiny, llama_tiny,
                    mixtral_8x7b)
from .gpt import (GPTConfig, GPTForCausalLM, GPTModel, gpt2_small,  # noqa: F401
                  gpt3_1p3b, gpt_tiny)
from .ernie import (ErnieConfig, ErnieForMaskedLM,  # noqa: F401
                    ErnieForSequenceClassification, ErnieModel, ernie3_base, ernie_tiny)
