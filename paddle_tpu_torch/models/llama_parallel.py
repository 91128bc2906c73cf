"""Hybrid-parallel Llama (port of the reference's ``models/llama_parallel.py``):
the flagship distributed configuration, dp x sharding x tp x pp x sp.

- ``VocabParallelEmbedding`` and the column/row-parallel linears: tensor
  parallelism over ``model``;
- their sequence-parallel forms and ``ScatterOp``: sequence parallelism
  between the tensor-parallel regions (on when mp > 1 and sep == 1 unless
  ``sequence_parallel`` or ``PADDLE_TPU_SP`` says otherwise);
- ``ScannedLayers`` over the decoder stack: the ``pipe`` axis;
- ``DistributedTrainStep(sharding_stage=...)``: data parallelism and ZeRO
  over ``data`` x ``sharding``;
- ``context_parallel`` "ring" / "ulysses" over ``sep``
  (``meta_parallel.context_parallel``).

The parameters and their state-dict keys are the reference's (the stacked
``decoder.self_attn__q_proj__weight`` [L, in, out], ..., and the frozen
``decoder._template.*`` / ``decoder.template.*`` of one layer), so
``convert.load_numpy_state_dict`` carries the JAX model's state dict
across unchanged; :func:`stack_llama_state_dict` gives a plain
``LlamaForCausalLM``'s weights those keys.  Weights are drawn from N(0,
``initializer_range``) by a generator seeded with ``seed`` on ``device``
(default: the mesh's first member).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..distributed.engine import ScannedLayers
from ..distributed.meta_parallel.mp_layers import (ColumnParallelLinear,
                                                   ParallelCrossEntropy,
                                                   RowParallelLinear,
                                                   VocabParallelEmbedding)
from ..distributed.meta_parallel.sequence_parallel import (
    ColumnSequenceParallelLinear, RowSequenceParallelLinear, ScatterOp,
    register_sequence_parallel_allreduce_hooks, sequence_parallel_enabled)
from ..nn import RMSNorm
from ..nn import functional as F
from .llama import LlamaConfig, _normalize_mask, _rope_tables, apply_rotary_pos_emb

__all__ = ["LlamaForCausalLMHybrid", "HybridLlamaAttention", "HybridLlamaMLP",
           "HybridLlamaDecoderLayer", "stack_llama_state_dict"]


def _linear_types(sequence_parallel: bool):
    if sequence_parallel:
        return ColumnSequenceParallelLinear, RowSequenceParallelLinear
    return ColumnParallelLinear, RowParallelLinear


def _local_heads(n: int, linear) -> int:
    """Heads a process holds: across processes a column-parallel linear
    gives this process's columns only."""
    m = linear._model
    return n // m.n if m.multi else n


class HybridLlamaAttention(nn.Module):
    """Attention with its heads over ``model`` (q/k/v column-parallel, the
    output row-parallel)."""

    def __init__(self, config: LlamaConfig, context_parallel: str = "none",
                 sequence_parallel: bool = False, **init):
        super().__init__()
        self.config = config
        self.context_parallel = context_parallel
        h, kv, d, hs = (config.num_attention_heads, config.num_key_value_heads,
                        config.head_dim, config.hidden_size)
        Column, Row = _linear_types(sequence_parallel)
        self.q_proj = Column(hs, h * d, has_bias=False, gather_output=False, **init)
        self.k_proj = Column(hs, kv * d, has_bias=False, gather_output=False, **init)
        self.v_proj = Column(hs, kv * d, has_bias=False, gather_output=False, **init)
        self.o_proj = Row(h * d, hs, has_bias=False, input_is_parallel=True, **init)

    def forward(self, x, cos, sin, attn_mask=None):
        cfg = self.config
        d = cfg.head_dim
        q = self.q_proj(x)
        b, s = q.shape[:2]
        q = q.view(b, s, _local_heads(cfg.num_attention_heads, self.q_proj), d)
        k = self.k_proj(x).view(b, s, _local_heads(cfg.num_key_value_heads, self.k_proj), d)
        v = self.v_proj(x).view(b, s, _local_heads(cfg.num_key_value_heads, self.v_proj), d)
        q, k = apply_rotary_pos_emb(q, k, cos, sin)
        if self.context_parallel != "none":
            from ..distributed.meta_parallel.context_parallel import (ring_attention,
                                                                       ulysses_attention)

            if attn_mask is not None:
                raise NotImplementedError(
                    "context-parallel attention supports causal masking only")
            if self.context_parallel == "ring":
                out = ring_attention(q, k, v, causal=True)
            else:
                out = ulysses_attention(q, k, v, is_causal=True)
        else:
            out = F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask, is_causal=True)
        return self.o_proj(out.reshape(b, s, -1))


class HybridLlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, sequence_parallel: bool = False, **init):
        super().__init__()
        Column, Row = _linear_types(sequence_parallel)
        hs, inter = config.hidden_size, config.intermediate_size
        self.gate_proj = Column(hs, inter, has_bias=False, gather_output=False, **init)
        self.up_proj = Column(hs, inter, has_bias=False, gather_output=False, **init)
        self.down_proj = Row(inter, hs, has_bias=False, input_is_parallel=True, **init)

    def forward(self, x):
        return self.down_proj(F.swiglu(self.gate_proj(x), self.up_proj(x)))


class HybridLlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, context_parallel: str = "none",
                 sequence_parallel: bool = False, **init):
        super().__init__()
        place = dict(device=init.get("device"), dtype=init.get("dtype", torch.float32))
        self.self_attn = HybridLlamaAttention(config, context_parallel, sequence_parallel,
                                              **init)
        self.mlp = HybridLlamaMLP(config, sequence_parallel, **init)
        self.input_layernorm = RMSNorm(config.hidden_size, config.rms_norm_eps, **place)
        self.post_attention_layernorm = RMSNorm(config.hidden_size, config.rms_norm_eps,
                                                **place)

    def forward(self, x, cos, sin, attn_mask=None):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, attn_mask)
        return x + self.mlp(self.post_attention_layernorm(x))


class _Built:
    """A sequence of ``n`` layers built on access, so ``ScannedLayers``
    stacks them one at a time."""

    def __init__(self, n: int, make):
        self._n, self._make = n, make

    def __len__(self) -> int:
        return self._n

    def __iter__(self):
        return (self._make() for _ in range(self._n))


class LlamaForCausalLMHybrid(nn.Module):
    """``context_parallel``: "auto" (ring when sep > 1, else none), "none",
    "ring" or "ulysses".  ``sequence_parallel``: None defers to
    ``sequence_parallel_enabled``; forced off when sep > 1."""

    def __init__(self, config: LlamaConfig, hcg, context_parallel: str = "auto",
                 sequence_parallel: "bool | None" = None, *, device=None,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        self.config = config
        self.hcg = hcg
        mesh = hcg.mesh
        sep, mp = mesh.shape.get("sep", 1), mesh.shape.get("model", 1)
        sp = sequence_parallel_enabled(sequence_parallel) and mp > 1 and sep == 1
        self.sequence_parallel = sp
        if context_parallel == "auto":
            context_parallel = "ring" if sep > 1 else "none"
        if context_parallel not in ("none", "ring", "ulysses"):
            raise ValueError(f"context_parallel={context_parallel!r}: must be "
                             "'auto', 'none', 'ring' or 'ulysses'")
        if context_parallel == "ulysses" and config.num_key_value_heads % sep != 0:
            raise ValueError(
                f"ulysses needs kv heads ({config.num_key_value_heads}) divisible "
                f"by the sep degree ({sep}); lower sep or use ring attention")
        self.context_parallel = context_parallel
        if config.fused_ce_chunk > 0:
            raise ValueError(
                "fused_ce_chunk is a single-device memory lever; the hybrid model "
                "keeps the vocab dim split over the model axis instead — unset it")
        pp = hcg.get_pipe_parallel_world_size()
        if config.num_hidden_layers % pp != 0:
            raise ValueError(f"num_hidden_layers {config.num_hidden_layers} % pp {pp} != 0")
        device = resolve_device(device if device is not None else mesh.devices.flat[0])
        init = dict(std=config.initializer_range, device=device, dtype=dtype,
                    generator=torch.Generator(device=device).manual_seed(seed))
        self.embed_tokens = VocabParallelEmbedding(config.vocab_size, config.hidden_size,
                                                   **init)
        self.decoder = ScannedLayers(
            _Built(config.num_hidden_layers,
                   lambda: HybridLlamaDecoderLayer(config, context_parallel, sp, **init)),
            mesh=mesh, pipe_axis="pipe")
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps, device=device,
                            dtype=dtype)
        LMHead = ColumnSequenceParallelLinear if sp else ColumnParallelLinear
        self.lm_head = LMHead(config.hidden_size, config.vocab_size, has_bias=False,
                              gather_output=False, **init)
        cos, sin = _rope_tables(config.head_dim, config.max_position_embeddings,
                                config.rope_theta)
        self.register_buffer("rope_cos", cos.to(device), persistent=False)
        self.register_buffer("rope_sin", sin.to(device), persistent=False)
        if sp:
            register_sequence_parallel_allreduce_hooks(self)

    def forward(self, input_ids, labels=None, attn_mask=None):
        """Logits (across processes at mp > 1: this process's vocab
        columns); with ``labels``, ``(loss, logits)``, the mean cross
        entropy over the labels that are not -100."""
        if input_ids.shape[1] > self.config.max_position_embeddings:
            raise ValueError("sequence too long")
        ids = torch.as_tensor(input_ids, device=self.rope_cos.device)
        attn_mask = _normalize_mask(attn_mask)
        x = self.embed_tokens(ids)
        if self.sequence_parallel:
            x = ScatterOp.apply(x)
        x = self.decoder(x, self.rope_cos, self.rope_sin, attn_mask)
        logits = self.lm_head(self.norm(x))
        if labels is None:
            return logits
        labels = torch.as_tensor(labels, device=logits.device).reshape(-1)
        if self.lm_head._model.multi and self.lm_head._model.n > 1:
            per = ParallelCrossEntropy()(logits.reshape(-1, logits.shape[-1]), labels)
            loss = per.sum() / (labels != -100).sum()
        else:
            loss = F.cross_entropy(logits.reshape(-1, self.config.vocab_size), labels)
        return loss, logits


def stack_llama_state_dict(arrays: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A ``LlamaForCausalLM`` state dict (numpy arrays) under the keys and
    shapes of ``LlamaForCausalLMHybrid``'s: the decoder layers stacked
    along a leading dim, layer 0 also as the template."""
    out: Dict[str, np.ndarray] = {}
    layers: Dict[str, Dict[int, np.ndarray]] = {}
    for key, arr in arrays.items():
        if key.startswith("llama.layers."):
            i, sub = key[len("llama.layers."):].split(".", 1)
            layers.setdefault(sub, {})[int(i)] = np.asarray(arr)
        elif key.startswith("llama."):
            out[key[len("llama."):]] = np.asarray(arr)
        else:
            out[key] = np.asarray(arr)
    for sub, by_layer in layers.items():
        out["decoder." + sub.replace(".", "__")] = np.stack(
            [by_layer[i] for i in sorted(by_layer)])
        for prefix in ("decoder._template.", "decoder.template."):
            out[prefix + sub] = by_layer[min(by_layer)]
    return out
