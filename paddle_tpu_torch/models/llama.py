"""The Llama family for serving and training (port of the reference's
``models/llama.py``), MoE variants included: every ``moe_every``-th
decoder layer's MLP is an ``ExpertParallelMLP`` when ``moe_num_experts >
0``, and the training loss adds 0.01 × :meth:`LlamaForCausalLM.moe_aux_loss`.

Parameter names and layouts are those of the JAX model (paddle ``[in, out]``
Linear weights), so its ``state_dict`` loads through
:func:`paddle_tpu_torch.convert.load_numpy_state_dict`.  Attention runs in
the [batch, seq, heads, head_dim] layout; GQA reads the shared KV head
without repeating it; the rotary tables are precomputed once in f32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..distributed.fleet_utils import recompute
from ..generation import GenerationMixin, cached_attention
from ..incubate.distributed.models.moe import ExpertParallelMLP
from ..nn import Embedding, Layer, LayerList, Linear, RMSNorm
from ..nn import functional as F
from ..ops.rope import rotate
from ..ops.sharded import mesh_route, mesh_rope, mesh_rope_supported

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM", "llama_tiny",
           "llama2_7b", "llama2_13b", "llama2_70b", "llama_moe_tiny", "mixtral_8x7b",
           "apply_rotary_pos_emb", "apply_rotary_at_positions"]

MOE_AUX_WEIGHT = 0.01   # the routers' aux loss in the training loss

KVCache = List[Tuple[torch.Tensor, torch.Tensor]]


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    initializer_range: float = 0.02
    recompute: bool = False  # rematerialize each decoder layer in backward
    # MoE: an ExpertParallelMLP in every moe_every-th layer
    moe_num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 2.0
    moe_every: int = 1
    moe_expert_axes: tuple = None  # mesh axes the experts split over
    # > 0: training loss by F.fused_linear_cross_entropy in chunks of this
    # many tokens, returning (loss, None)
    fused_ce_chunk: int = 0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def llama_tiny(**kw) -> LlamaConfig:
    """Test-scale config."""
    base = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                max_position_embeddings=128)
    base.update(kw)
    return LlamaConfig(**base)


def llama2_7b(**kw) -> LlamaConfig:
    base = dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=32,
                max_position_embeddings=4096)
    base.update(kw)
    return LlamaConfig(**base)


def llama2_13b(**kw) -> LlamaConfig:
    base = dict(hidden_size=5120, intermediate_size=13824, num_hidden_layers=40,
                num_attention_heads=40, num_key_value_heads=40)
    base.update(kw)
    return LlamaConfig(**base)


def llama_moe_tiny(**kw) -> LlamaConfig:
    """Test-scale MoE config: 4 experts, top-2, every layer."""
    base = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                max_position_embeddings=128, moe_num_experts=4, moe_top_k=2)
    base.update(kw)
    return LlamaConfig(**base)


def mixtral_8x7b(**kw) -> LlamaConfig:
    """Mixtral-8x7B's widths (8 experts, top-2, GQA 32:8), as the
    reference's config has them."""
    base = dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
                num_hidden_layers=32, num_attention_heads=32,
                num_key_value_heads=8, max_position_embeddings=4096,
                moe_num_experts=8, moe_top_k=2)
    base.update(kw)
    return LlamaConfig(**base)


def llama2_70b(**kw) -> LlamaConfig:
    base = dict(hidden_size=8192, intermediate_size=28672, num_hidden_layers=80,
                num_attention_heads=64, num_key_value_heads=8)
    base.update(kw)
    return LlamaConfig(**base)


def _normalize_mask(attn_mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """bool/int keep-mask ([b, s] or broadcastable) → additive f32 mask;
    a float mask passes through (already additive)."""
    if attn_mask is None or attn_mask.is_floating_point():
        return attn_mask
    keep = attn_mask.float()
    if keep.dim() == 2:  # [b, s] padding mask → [b, 1, 1, s]
        keep = keep[:, None, None, :]
    return (1.0 - keep) * torch.finfo(torch.float32).min


def _rope_tables(head_dim: int, max_pos: int, theta: float):
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))
    t = np.arange(max_pos, dtype=np.float32)
    freqs = np.outer(t, inv_freq)                      # [max_pos, head_dim/2]
    emb = np.concatenate([freqs, freqs], axis=-1)      # [max_pos, head_dim]
    return torch.from_numpy(np.cos(emb)), torch.from_numpy(np.sin(emb))


def apply_rotary_pos_emb(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
                         sin: torch.Tensor, position_offset: int = 0,
                         pad_lens: Optional[torch.Tensor] = None):
    """Rotate q [b, s, h, d] and k at positions ``position_offset + j``,
    less ``pad_lens[b]`` per row when given (left-padded rows; positions
    inside the padding clip to 0).  One kernel serves every case.  Under a
    live single-controller mesh, rows without padding go through
    ``mesh_rope`` (each member rotates its block), as the reference's do."""
    b, s = q.shape[0], q.shape[1]
    mesh = mesh_route("use_fused_rope") if pad_lens is None else None
    if mesh is not None and mesh_rope_supported(mesh, q.shape, k.shape) \
            and position_offset + s <= cos.shape[0]:
        rows = slice(position_offset, position_offset + s)
        return mesh_rope(q, k, cos[rows], sin[rows], mesh)
    pos_ids = position_offset + torch.arange(s, device=q.device,
                                             dtype=torch.int32)[None, :]
    pos_ids = (pos_ids.expand(b, s) if pad_lens is None
               else pos_ids - pad_lens.to(torch.int32)[:, None]).contiguous()
    return apply_rotary_at_positions(q, k, cos, sin, pos_ids)


def apply_rotary_at_positions(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
                              sin: torch.Tensor, pos_ids: torch.Tensor):
    """Rotate q [b, s, h, d] and k at per-row positions ``pos_ids`` [b, s]
    int32 (clipped into the [max_pos, d] f32 tables), in f32: the
    counterpart of the reference's ``rotate_half_apply`` over gathered
    cos/sin rows, which its serving engine applies at each row's own
    positions.  Goes through the rope kernel (B2) on the card when
    ``use_fused_rope`` is on, as every other rope of the port does."""
    return rotate(q, k, cos, sin, pos_ids)


class LlamaAttention(Layer):
    def __init__(self, config: LlamaConfig, **init):
        super().__init__()
        self.config = config
        h, kv, d = config.num_attention_heads, config.num_key_value_heads, config.head_dim
        hs = config.hidden_size
        self.q_proj = Linear(hs, h * d, bias_attr=False, **init)
        self.k_proj = Linear(hs, kv * d, bias_attr=False, **init)
        self.v_proj = Linear(hs, kv * d, bias_attr=False, **init)
        self.o_proj = Linear(h * d, hs, bias_attr=False, **init)

    def forward(self, x, cos, sin, attn_mask=None, position_offset: int = 0,
                kv_cache=None, pad_lens=None):
        b, s = x.shape[0], x.shape[1]
        cfg = self.config
        h, kv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        q = self.q_proj(x).view(b, s, h, d)
        k = self.k_proj(x).view(b, s, kv, d)
        v = self.v_proj(x).view(b, s, kv, d)
        if kv_cache is not None:
            # decode path (generation/): k/v go into the static cache at
            # position_offset, IN PLACE; pad_lens carries per-row left padding
            if attn_mask is not None:
                raise NotImplementedError(
                    "attn_mask with kv_cache is not supported: ragged batched "
                    "prompts go through generate(attention_mask=...)")
            q, k = apply_rotary_pos_emb(q, k, cos, sin, position_offset, pad_lens)
            out, ck, cv = cached_attention(q, k, v, kv_cache[0], kv_cache[1],
                                           position_offset, pad_lens)
            return self.o_proj(out.reshape(b, s, h * d)), (ck, cv)
        q, k = apply_rotary_pos_emb(q, k, cos, sin, position_offset)
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                             is_causal=True)
        return self.o_proj(out.reshape(b, s, h * d))


class LlamaMLP(Layer):
    def __init__(self, config: LlamaConfig, **init):
        super().__init__()
        hs, inter = config.hidden_size, config.intermediate_size
        self.gate_proj = Linear(hs, inter, bias_attr=False, **init)
        self.up_proj = Linear(hs, inter, bias_attr=False, **init)
        self.down_proj = Linear(inter, hs, bias_attr=False, **init)

    def forward(self, x):
        return self.down_proj(F.swiglu(self.gate_proj(x), self.up_proj(x)))


class LlamaDecoderLayer(Layer):
    def __init__(self, config: LlamaConfig, use_moe: bool = False, **init):
        super().__init__()
        place = dict(device=init["device"], dtype=init["dtype"])
        self.self_attn = LlamaAttention(config, **init)
        if use_moe:
            self.mlp = ExpertParallelMLP(
                config.hidden_size, config.intermediate_size,
                num_experts=config.moe_num_experts, top_k=config.moe_top_k,
                capacity_factor=config.moe_capacity_factor, activation="swiglu",
                expert_axes=config.moe_expert_axes, param_dtype=init["dtype"],
                device=init["device"], generator=init["generator"])
        else:
            self.mlp = LlamaMLP(config, **init)
        self.input_layernorm = RMSNorm(config.hidden_size, config.rms_norm_eps, **place)
        self.post_attention_layernorm = RMSNorm(config.hidden_size,
                                                config.rms_norm_eps, **place)

    def forward(self, x, cos, sin, attn_mask=None, position_offset: int = 0,
                kv_cache=None, pad_lens=None):
        if kv_cache is not None:
            attn, new_cache = self.self_attn(self.input_layernorm(x), cos, sin,
                                             attn_mask, position_offset,
                                             kv_cache, pad_lens)
            x = x + attn
            x = x + self.mlp(self.post_attention_layernorm(x))
            return x, new_cache
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, attn_mask,
                               position_offset)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(Layer):
    def __init__(self, config: LlamaConfig, **init):
        super().__init__()
        self.config = config
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size, **init)
        self.layers = LayerList([
            LlamaDecoderLayer(config, use_moe=config.moe_num_experts > 0
                              and i % config.moe_every == 0, **init)
            for i in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps,
                            device=init["device"], dtype=init["dtype"])
        cos, sin = _rope_tables(config.head_dim, config.max_position_embeddings,
                                config.rope_theta)
        # f32 tables whatever the weights' dtype (the rope kernel takes f32)
        self.register_buffer("rope_cos", cos.to(init["device"]), persistent=False)
        self.register_buffer("rope_sin", sin.to(init["device"]), persistent=False)

    def forward(self, input_ids, attn_mask=None, position_offset: int = 0,
                kv_cache: Optional[KVCache] = None, pad_lens=None):
        """``attn_mask``: additive float mask or bool/int keep-mask (causal
        masking always applies).  ``kv_cache``: per-layer (k, v) static
        caches, updated in place; returns (hidden, kv_cache).  ``pad_lens``
        [b]: per-row LEFT padding (cache path only)."""
        s = input_ids.shape[1]
        if s + position_offset > self.config.max_position_embeddings:
            raise ValueError(
                f"sequence length {s} (+offset {position_offset}) exceeds "
                f"max_position_embeddings {self.config.max_position_embeddings}")
        attn_mask = _normalize_mask(attn_mask)
        x = self.embed_tokens(input_ids)
        cos, sin = self.rope_cos.float(), self.rope_sin.float()
        if kv_cache is not None:
            new_caches = []
            for layer, lc in zip(self.layers, kv_cache):
                x, nc = layer(x, cos, sin, attn_mask, position_offset,
                              kv_cache=lc, pad_lens=pad_lens)
                new_caches.append(nc)
            return self.norm(x), new_caches
        for layer in self.layers:
            # MoE layers run un-checkpointed, as the reference's: their
            # aux loss leaves the layer as a side channel (l_aux)
            if self.config.recompute and not isinstance(layer.mlp, ExpertParallelMLP):
                x = recompute(layer, x, cos, sin, attn_mask, position_offset)
            else:
                x = layer(x, cos, sin, attn_mask, position_offset)
        return self.norm(x)


class LlamaForCausalLM(Layer, GenerationMixin):
    """Llama with its LM head.  Weights are drawn from N(0,
    ``initializer_range``) (an MoE layer's XavierUniform, as the
    reference's), directly in ``dtype``, by a ``torch.Generator`` seeded
    with ``seed`` on ``device`` (the card unless the caller asks for the
    CPU)."""

    def __init__(self, config: LlamaConfig, *, device=None,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        init = dict(std=config.initializer_range, device=device, dtype=dtype,
                    generator=torch.Generator(device=device).manual_seed(seed))
        self.llama = LlamaModel(config, **init)
        self.lm_head = None if config.tie_word_embeddings else Linear(
            config.hidden_size, config.vocab_size, bias_attr=False, **init)

    def forward(self, input_ids, labels=None, attn_mask=None, kv_cache=None,
                position_offset: int = 0, pad_lens=None):
        """Logits; with ``labels`` [b, s] (next-token ids, -100 ignored),
        ``(loss, logits)`` with the mean cross entropy in f32, or ``(loss,
        None)`` when ``fused_ce_chunk > 0`` (the chunked fused loss, which
        makes no logits); with ``kv_cache``, ``(logits, kv_cache)``."""
        if kv_cache is not None:  # decode path: (logits, kv_cache)
            hidden, new_cache = self.llama(input_ids, attn_mask, position_offset,
                                           kv_cache=kv_cache, pad_lens=pad_lens)
            return self._logits(hidden), new_cache
        hidden = self.llama(input_ids, attn_mask)
        if labels is not None and self.config.fused_ce_chunk > 0:
            # the chunked fused linear + cross entropy: the [tokens, vocab]
            # logits are never made, so none are returned
            head_w = self.lm_head.weight if self.lm_head is not None \
                else self.llama.embed_tokens.weight.T  # tied embeddings
            loss = F.fused_linear_cross_entropy(
                hidden.reshape(-1, self.config.hidden_size), head_w,
                torch.as_tensor(labels, device=hidden.device).reshape(-1),
                chunk_size=self.config.fused_ce_chunk)
            return self._with_aux(loss), None
        logits = self._logits(hidden)
        if labels is None:
            return logits
        loss = F.cross_entropy(logits.reshape(-1, self.config.vocab_size),
                               torch.as_tensor(labels, device=logits.device).reshape(-1))
        return self._with_aux(loss), logits

    def _with_aux(self, loss):
        if self.config.moe_num_experts > 0:
            loss = loss + MOE_AUX_WEIGHT * self.moe_aux_loss()
        return loss

    def moe_aux_loss(self):
        """The sum of the routers' load-balance losses of the last forward
        (the GShard aux loss), in layer order."""
        aux = None
        for layer in self.llama.layers:
            la = getattr(layer.mlp, "l_aux", None)
            if la is not None:
                aux = la if aux is None else aux + la
        if aux is None:
            raise RuntimeError("moe_aux_loss: no MoE layers or no forward yet")
        return aux

    def _logits(self, hidden):
        if self.lm_head is not None:
            return self.lm_head(hidden)
        return F.linear(hidden, self.llama.embed_tokens.weight.T)

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())
