"""The GPT family for training and serving (port of the reference's
``models/gpt.py``): pre-norm GPT with learned positions, LayerNorm, a GELU
MLP, causal attention in the [batch, seq, heads, head_dim] layout and an
LM head tied to the token embedding.

Parameter names and layouts are those of the JAX model (paddle ``[in, out]``
Linear weights with biases), so its ``state_dict`` loads through
:func:`paddle_tpu_torch.convert.load_numpy_state_dict`.  Without dropout,
each block's second residual add and ``ln_2`` are one
``incubate.nn.functional.fused_layer_norm`` call: the fused residual-add +
LayerNorm (B11, B11b) when ``use_fused_layernorm`` is on.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from ..device import resolve_device
from ..distributed.fleet_utils import recompute
from ..generation import GenerationMixin, cached_attention
from ..incubate.nn.functional import fused_layer_norm
from ..nn import Dropout, Embedding, Layer, LayerList, LayerNorm, Linear
from ..nn import functional as F

__all__ = ["GPTConfig", "GPTBlock", "GPTModel", "GPTForCausalLM", "gpt_tiny",
           "gpt2_small", "gpt3_1p3b"]

KVCache = List[Tuple[torch.Tensor, torch.Tensor]]


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 2048
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 8192
    max_position_embeddings: int = 2048
    layer_norm_eps: float = 1e-5
    dropout: float = 0.0
    initializer_range: float = 0.02
    recompute: bool = False  # rematerialize each block in backward
    # per-head width; hidden_size // num_attention_heads when not given
    head_dim: int = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.head_dim is None:
            self.head_dim = self.hidden_size // self.num_attention_heads


def gpt_tiny(**kw) -> GPTConfig:
    """Test-scale config."""
    base = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=128, max_position_embeddings=128)
    base.update(kw)
    return GPTConfig(**base)


def gpt2_small(**kw) -> GPTConfig:
    base = dict(vocab_size=50304, hidden_size=768, num_hidden_layers=12,
                num_attention_heads=12, intermediate_size=3072,
                max_position_embeddings=1024)
    base.update(kw)
    return GPTConfig(**base)


def gpt3_1p3b(**kw) -> GPTConfig:
    base = dict(vocab_size=50304, hidden_size=2048, num_hidden_layers=24,
                num_attention_heads=16, intermediate_size=8192,
                max_position_embeddings=2048)
    base.update(kw)
    return GPTConfig(**base)


class GPTBlock(Layer):
    def __init__(self, config: GPTConfig, **init):
        super().__init__()
        place = dict(device=init["device"], dtype=init["dtype"])
        hs, h, d = config.hidden_size, config.num_attention_heads, config.head_dim
        self.ln_1 = LayerNorm(hs, config.layer_norm_eps, **place)
        self.qkv_proj = Linear(hs, 3 * h * d, **init)
        self.out_proj = Linear(h * d, hs, **init)
        self.ln_2 = LayerNorm(hs, config.layer_norm_eps, **place)
        self.fc_in = Linear(hs, config.intermediate_size, **init)
        self.fc_out = Linear(config.intermediate_size, hs, **init)
        self.dropout = Dropout(config.dropout)
        self.config = config

    def forward(self, x, position_offset: int = 0, kv_cache=None, pad_lens=None):
        cfg = self.config
        b, s = x.shape[0], x.shape[1]
        h, d = cfg.num_attention_heads, cfg.head_dim
        qkv = self.qkv_proj(self.ln_1(x)).view(b, s, 3, h, d)
        # one copy makes q, k and v contiguous (the attention kernels take
        # contiguous [b, s, h, d] tensors)
        q, k, v = qkv.permute(2, 0, 1, 3, 4).contiguous().unbind(0)
        if kv_cache is not None:
            out, ck, cv = cached_attention(q, k, v, kv_cache[0], kv_cache[1],
                                           position_offset, pad_lens)
            x = x + self.dropout(self.out_proj(out.reshape(b, s, h * d)))
            x = x + self.dropout(self.fc_out(F.gelu(self.fc_in(self.ln_2(x)))))
            return x, (ck, cv)
        attn = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              dropout_p=cfg.dropout,
                                              training=self.training)
        a = self.out_proj(attn.reshape(b, s, h * d))
        if cfg.dropout == 0.0:
            # ln_2(x + a) and the sum from one residual-add + LayerNorm
            y, hsum = fused_layer_norm(a, self.ln_2.weight, self.ln_2.bias,
                                       epsilon=cfg.layer_norm_eps, residual=x)
            return hsum + self.fc_out(F.gelu(self.fc_in(y)))
        x = x + self.dropout(a)
        return x + self.dropout(self.fc_out(F.gelu(self.fc_in(self.ln_2(x)))))


class GPTModel(Layer):
    def __init__(self, config: GPTConfig, **init):
        super().__init__()
        self.config = config
        self.wte = Embedding(config.vocab_size, config.hidden_size, **init)
        self.wpe = Embedding(config.max_position_embeddings, config.hidden_size, **init)
        self.drop = Dropout(config.dropout)
        self.h = LayerList([GPTBlock(config, **init)
                                for _ in range(config.num_hidden_layers)])
        self.ln_f = LayerNorm(config.hidden_size, config.layer_norm_eps,
                              device=init["device"], dtype=init["dtype"])

    def forward(self, input_ids, position_offset: int = 0,
                kv_cache: Optional[KVCache] = None, pad_lens=None):
        """Hidden states; with ``kv_cache`` (per-layer (k, v) static caches,
        updated in place), ``(hidden, kv_cache)``.  ``pad_lens`` [b]: per-row
        LEFT padding; a padded row's positions shift back by its pad count
        (those inside the padding clip to 0)."""
        s = input_ids.shape[1]
        max_pos = self.config.max_position_embeddings
        if s + position_offset > max_pos:
            raise ValueError(f"sequence length {s} (+offset {position_offset}) exceeds "
                             f"max_position_embeddings {max_pos}")
        pos = torch.arange(s, device=input_ids.device) + position_offset
        if pad_lens is not None:
            pos = (pos[None, :] - pad_lens.long()[:, None]).clamp(0, max_pos - 1)
        x = self.drop(self.wte(input_ids) + self.wpe(pos))
        if kv_cache is not None:
            new_caches = []
            for block, lc in zip(self.h, kv_cache):
                x, nc = block(x, position_offset, kv_cache=lc, pad_lens=pad_lens)
                new_caches.append(nc)
            return self.ln_f(x), new_caches
        for block in self.h:
            x = recompute(block, x) if self.config.recompute else block(x)
        return self.ln_f(x)


class GPTForCausalLM(Layer, GenerationMixin):
    """GPT with the LM head tied to ``wte``.  Weights are drawn from N(0,
    ``initializer_range``) by a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, config: GPTConfig, *, device=None,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        init = dict(std=config.initializer_range, device=device, dtype=dtype,
                    generator=torch.Generator(device=device).manual_seed(seed))
        self.gpt = GPTModel(config, **init)

    def forward(self, input_ids, labels=None, kv_cache=None, position_offset: int = 0,
                pad_lens=None):
        """Logits; with ``labels`` [b, s], ``(loss, logits)`` with the mean
        cross entropy in f32; with ``kv_cache``, ``(logits, kv_cache)``."""
        if kv_cache is not None:  # decode path: (logits, kv_cache)
            hidden, new_cache = self.gpt(input_ids, position_offset, kv_cache=kv_cache,
                                         pad_lens=pad_lens)
            return F.linear(hidden, self.gpt.wte.weight.T), new_cache
        logits = F.linear(self.gpt(input_ids), self.gpt.wte.weight.T)
        if labels is None:
            return logits
        loss = F.cross_entropy(logits.reshape(-1, self.config.vocab_size),
                               torch.as_tensor(labels, device=logits.device).reshape(-1))
        return loss, logits

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())
