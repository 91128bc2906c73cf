"""Autoregressive decoding over a static KV cache: ``cached_attention``,
``rope_with_row_offsets``, ``GenerationMixin.generate`` and speculative
decoding (port of the reference's ``generation/__init__.py``).

The reference compiles the whole generation into one XLA program; here it
is an eager loop: one prefill forward, then one forward per new token.  The
cache is a list of per-layer ``(k, v)`` tensors of static shape
``[batch, capacity, kv_heads, head_dim]``, written IN PLACE at each step's
position.  Greedy and sampled decoding, the eos/pad latch,
``min_new_tokens``, ``repetition_penalty``, left-padded ``attention_mask``
batches, ``bucket="pow2"``, beam search (``num_beams`` > 1,
:mod:`.beam_search`) and ``num_return_sequences`` behave as in the
reference; sampling draws from a ``torch.Generator`` seeded with ``seed``
(its numbers differ from ``jax.random``'s).  :mod:`.speculative` holds the
drafters and ``speculative_generate``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..nn import functional as F
from ..ops import use_kernel
from ..ops.decode_attention import decode_attention, decode_attention_plain
from ..ops.flash_attention import flash_attention_fwd
from .beam_search import beam_search_loop
from .speculative import (AdaptiveK, DraftModelDrafter, NGramDrafter,  # noqa: F401
                          ShallowExitDrafter, SpecConfig, rejection_sample_step,
                          speculative_generate)

__all__ = ["GenerationMixin", "cached_attention", "rope_with_row_offsets",
           "SpecConfig", "AdaptiveK", "NGramDrafter", "DraftModelDrafter",
           "ShallowExitDrafter", "rejection_sample_step", "speculative_generate"]

_F32_MIN = torch.finfo(torch.float32).min


def cached_attention(q, k_new, v_new, cache_k, cache_v, pos: int, pad_lens=None):
    """Write ``k_new``/``v_new`` [b, s, kv, d] into the caches [b, C, kv, d]
    at ``pos`` IN PLACE and attend q [b, s, h, d] over the cache prefix
    (absolute-position causal mask; columns below ``pad_lens[b]`` masked).
    Returns (out [b, s, h, d], cache_k, cache_v)."""
    b, s, h, d = q.shape
    if s == 1:  # decode step
        if use_kernel("use_decode_attention", q):
            return decode_attention(q, k_new, v_new, cache_k, cache_v, pos, pad_lens)
        return (decode_attention_plain(q, k_new, v_new, cache_k, cache_v, pos,
                                       pad_lens), cache_k, cache_v)
    cache_k[:, pos:pos + s] = k_new
    cache_v[:, pos:pos + s] = v_new
    if pos == 0 and pad_lens is None:
        # prefill: the prefix being attended is q's own window
        out = F.scaled_dot_product_attention(q, k_new, v_new, is_causal=True)
        return out, cache_k, cache_v
    if pos == 0 and use_kernel("use_flash_attention", q):
        # left-padded prefill: the varlen flash kernel masks each row's pad
        out = flash_attention_fwd(q, k_new, v_new, True, pad_lens)[0]
        return out, cache_k, cache_v
    # the dense grouped-head path over the whole cache, scores in f32
    C, kv = cache_k.shape[1], cache_k.shape[2]
    g = h // kv
    q5 = q.reshape(b, s, kv, g, d).float()
    scores = torch.einsum("bskgd,bckd->bkgsc", q5, cache_k.float()) / float(d) ** 0.5
    col = torch.arange(C, device=q.device)
    allowed = col <= (pos + torch.arange(s, device=q.device))[:, None]
    if pad_lens is not None:
        allowed = allowed & (col >= pad_lens.long()[:, None, None, None, None])
    scores = scores.masked_fill(~allowed, _F32_MIN)
    out = torch.einsum("bkgsc,bckd->bskgd", torch.softmax(scores, dim=-1),
                       cache_v.float())
    return out.reshape(b, s, h, d).to(q.dtype), cache_k, cache_v


def rope_with_row_offsets(q, k, cos, sin, pos: int, pad_lens):
    """Rotary embedding with per-row positions for left-padded rows: row i's
    token at cache slot ``pos + j`` sits at logical position
    ``pos + j - pad_lens[i]`` (clipped at 0 inside the padding)."""
    from ..models.llama import apply_rotary_pos_emb

    return apply_rotary_pos_emb(q, k, cos, sin, pos, pad_lens)


def _as_numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class GenerationMixin:
    """``model.generate(input_ids, max_new_tokens=...)`` for causal-LM
    modules whose forward takes ``kv_cache``/``position_offset``/``pad_lens``
    and then returns ``(logits, kv_cache)``.

    Returns ``(ids, scores)``: the generated ids [batch, max_new_tokens]
    (int32, prompt not included) and the f32 log-probability of each chosen
    token, on the model's device."""

    def _kv_cache_spec(self) -> Tuple[int, int, int]:
        """(num_layers, kv_heads, head_dim) of the model's KV cache; a
        family without grouped heads (GPT) caches every attention head."""
        cfg = self.config
        kv = getattr(cfg, "num_key_value_heads", cfg.num_attention_heads)
        return cfg.num_hidden_layers, kv, cfg.head_dim

    def new_kv_cache(self, batch: int, capacity: int, layers: Optional[int] = None
                     ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Zeroed per-layer (k, v) caches [batch, capacity, kv, d] in the
        dtype of the first floating parameter, on the model's device: one
        pair a layer, or for the first ``layers`` layers."""
        n, kv, d = self._kv_cache_spec()
        layers = n if layers is None else layers
        p = next(p for p in self.parameters() if p.is_floating_point())
        shape = (batch, capacity, kv, d)
        return [(torch.zeros(shape, dtype=p.dtype, device=p.device),
                 torch.zeros(shape, dtype=p.dtype, device=p.device))
                for _ in range(layers)]

    @torch.inference_mode()
    def generate(self, input_ids, max_new_tokens: int = 64,
                 do_sample: bool = False, top_k: int = 0, top_p: float = 1.0,
                 temperature: float = 1.0, eos_token_id: Optional[int] = None,
                 pad_token_id: Optional[int] = None, seed: int = 0,
                 min_new_tokens: int = 0, repetition_penalty: float = 1.0,
                 attention_mask=None, num_beams: int = 1,
                 length_penalty: float = 1.0, early_stopping: bool = False,
                 num_return_sequences: int = 1, bucket: Optional[str] = None):
        """Greedy (``do_sample=False``), sampled (temperature, top-k,
        top-p) or, with ``num_beams`` > 1, beam-search decoding.
        ``input_ids`` [batch, prompt_len]; ragged prompts are LEFT-padded
        with ``attention_mask`` (1 = real token), and every row decodes as
        if unpadded.  Rows that emit ``eos_token_id`` are latched and emit
        ``pad_token_id`` (default: eos) afterwards.  ``min_new_tokens``
        suppresses eos until that many tokens are out;
        ``repetition_penalty`` > 1 divides positive (multiplies negative)
        logits of tokens already in the prompt or generated.
        ``bucket="pow2"`` left-pads the prompt to the next power of two
        (>= 16, capped by the position budget).

        Beam search scores a hypothesis ``cum_logprob /
        len**length_penalty``; ``early_stopping=True`` stops a row once it
        holds ``num_beams`` hypotheses, False while a running beam could
        still win.  It returns the best ``num_return_sequences`` hypotheses
        of each row, ``[batch * num_return_sequences, max_new_tokens]`` ids
        and one f32 score each.  With sampling, ``num_return_sequences``
        repeats each row that many times (distinct samples)."""
        device = next(iter(self.parameters())).device
        ids = torch.as_tensor(_as_numpy(input_ids)).to(device=device,
                                                        dtype=torch.int64)
        if ids.dim() != 2:
            raise ValueError(f"input_ids must be [batch, seq], got {tuple(ids.shape)}")
        if bucket is not None:
            if bucket != "pow2":
                raise ValueError(f"bucket={bucket!r}: only 'pow2' supported")
            cur, nb = int(ids.shape[1]), int(ids.shape[0])
            cap = self.config.max_position_embeddings - int(max_new_tokens)
            tgt = max(min(max(16, 1 << (cur - 1).bit_length()), cap), cur)
            if tgt > cur:
                extra = tgt - cur
                ids = torch.cat([ids.new_zeros(nb, extra), ids], dim=1)
                m = (np.ones((nb, cur), np.int32) if attention_mask is None
                     else _as_numpy(attention_mask).astype(np.int32))
                attention_mask = np.concatenate(
                    [np.zeros((nb, extra), np.int32), m], axis=1)
        pad_lens = None
        if attention_mask is not None:
            m = _as_numpy(attention_mask).astype(np.int32)
            if m.shape != tuple(ids.shape):
                raise ValueError(f"attention_mask shape {m.shape} != input_ids "
                                 f"{tuple(ids.shape)}")
            if not np.isin(m, (0, 1)).all():
                raise ValueError("attention_mask must be a binary 0/1 keep-mask")
            if not (np.diff(m, axis=1) >= 0).all():
                raise ValueError("attention_mask must be LEFT-padded (0s then "
                                 "1s per row)")
            if (m.sum(axis=1) == 0).any():
                raise ValueError("attention_mask has an all-pad row")
            pad_lens = torch.as_tensor(m.shape[1] - m.sum(axis=1),
                                       dtype=torch.int32, device=device)
        b, prompt = int(ids.shape[0]), int(ids.shape[1])
        max_new = int(max_new_tokens)
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        max_pos = self.config.max_position_embeddings
        if prompt + max_new > max_pos:
            raise ValueError(
                f"prompt ({prompt}) + max_new_tokens ({max_new}) = "
                f"{prompt + max_new} exceeds max_position_embeddings {max_pos}")
        eos = -1 if eos_token_id is None else int(eos_token_id)
        pad = eos if pad_token_id is None else int(pad_token_id)
        min_new = int(min_new_tokens)
        if not 0 <= min_new <= max_new:
            raise ValueError("min_new_tokens must be in [0, max_new_tokens]")
        if repetition_penalty <= 0:
            raise ValueError("repetition_penalty must be > 0")
        nrs = int(num_return_sequences)
        if num_beams > 1:
            if do_sample:
                raise ValueError("num_beams > 1 requires do_sample=False "
                                 "(beam-sample is not supported)")
            if repetition_penalty != 1.0:
                raise NotImplementedError(
                    "repetition_penalty with beam search is not supported")
            if not 1 <= nrs <= num_beams:
                raise ValueError("num_return_sequences must be in [1, num_beams]")
            ids_k, scores_k = self._generate_beam(
                ids, pad_lens, max_new, int(num_beams), eos, pad, min_new,
                float(length_penalty), bool(early_stopping))
            return (ids_k[:, :nrs].reshape(b * nrs, max_new),
                    scores_k[:, :nrs].reshape(b * nrs))
        if nrs != 1:
            if not do_sample:
                raise ValueError("num_return_sequences > 1 requires num_beams > 1 "
                                 "or do_sample=True")
            if nrs < 1:
                raise ValueError("num_return_sequences must be >= 1")
            # each row nrs times; the draws differ row by row
            ids = ids.repeat_interleave(nrs, dim=0)
            if pad_lens is not None:
                pad_lens = pad_lens.repeat_interleave(nrs, dim=0)
            b = b * nrs

        gen = torch.Generator(device=device).manual_seed(int(seed)) \
            if do_sample else None
        rp = float(repetition_penalty)

        def sample(logits, seen, step):
            logits = logits.float()
            if seen is not None:  # CTRL repetition penalty
                penal = torch.where(logits > 0, logits / rp, logits * rp)
                logits = torch.where(seen, penal, logits)
            if eos >= 0 and step < min_new:  # no eos before min_new tokens
                logits = logits.clone()
                logits[:, eos] = _F32_MIN
            if not do_sample:
                logprobs = torch.log_softmax(logits, dim=-1)
                tok = logits.argmax(dim=-1)
            else:
                scaled = logits / max(temperature, 1e-6)
                if top_k and top_k > 0:
                    k_eff = min(int(top_k), scaled.shape[-1])
                    kth = scaled.topk(k_eff, dim=-1).values[:, -1:]
                    scaled = scaled.masked_fill(scaled < kth, _F32_MIN)
                if top_p < 1.0:
                    # the smallest set with cumulative prob >= top_p (the
                    # chosen token itself always survives)
                    srt = scaled.sort(dim=-1, descending=True).values
                    cdf = torch.softmax(srt, dim=-1).cumsum(dim=-1)
                    cut = (cdf < top_p).sum(dim=-1, keepdim=True)
                    kth = srt.gather(1, cut.clamp(max=srt.shape[-1] - 1))
                    scaled = scaled.masked_fill(scaled < kth, _F32_MIN)
                tok = torch.multinomial(torch.softmax(scaled, dim=-1), 1,
                                        generator=gen)[:, 0]
                # scores follow the distribution actually sampled from
                logprobs = torch.log_softmax(scaled, dim=-1)
            return tok, logprobs.gather(1, tok[:, None])[:, 0]

        # cache capacity rounded up to a multiple of 8, as in the reference
        caches = self.new_kv_cache(b, -(-(prompt + max_new) // 8) * 8)
        logits, _ = self(ids, kv_cache=caches, position_offset=0, pad_lens=pad_lens)
        rows = torch.arange(b, device=device)
        seen = None
        if rp != 1.0:
            vocab = logits.shape[-1]
            # pad filler ids never count as seen
            first = pad_lens if pad_lens is not None else torch.zeros_like(rows)
            real = torch.arange(prompt, device=device)[None, :] >= first[:, None]
            seen = torch.zeros(b, vocab + 1, dtype=torch.bool, device=device)
            seen.scatter_(1, torch.where(real, ids, vocab), True)
            seen = seen[:, :vocab]
        tok, logp = sample(logits[:, -1, :], seen, 0)
        done = tok == eos
        if seen is not None:
            seen[rows, tok] = True
        out_ids, out_scores = [tok], [logp]
        for t in range(1, max_new):
            logits, _ = self(tok[:, None], kv_cache=caches,
                             position_offset=prompt + t - 1, pad_lens=pad_lens)
            nxt, logp = sample(logits[:, -1, :], seen, t)
            nxt = torch.where(done, torch.full_like(nxt, pad), nxt)
            logp = torch.where(done, torch.zeros_like(logp), logp)
            done = done | (nxt == eos)
            if seen is not None:
                seen[rows, nxt] = True
            tok = nxt
            out_ids.append(tok)
            out_scores.append(logp)
        return (torch.stack(out_ids, dim=1).to(torch.int32),
                torch.stack(out_scores, dim=1))

    def _generate_beam(self, ids, pad_lens, max_new, K, eos, pad, min_new,
                       length_penalty, early_stopping):
        """Beam search: prefill at batch b, each cache tiled K-fold
        (beam-fastest rows), then :func:`.beam_search.beam_search_loop`.
        Returns ids [b, K, max_new] and scores [b, K]."""
        b, prompt = int(ids.shape[0]), int(ids.shape[1])
        caches = self.new_kv_cache(b, -(-(prompt + max_new) // 8) * 8)
        logits, _ = self(ids, kv_cache=caches, position_offset=0, pad_lens=pad_lens)
        caches = [(ck.repeat_interleave(K, dim=0), cv.repeat_interleave(K, dim=0))
                  for ck, cv in caches]
        beam_pad_lens = None if pad_lens is None else pad_lens.repeat_interleave(K, dim=0)

        def step(tok, caches, offset, pl):
            logits, caches = self(tok, kv_cache=caches, position_offset=offset, pad_lens=pl)
            return logits[:, -1, :], caches

        return beam_search_loop(
            step, caches, logits[:, -1, :], num_beams=K, max_new=max_new, eos=eos,
            pad=pad, length_penalty=length_penalty, early_stopping=early_stopping,
            min_new=min_new, prompt_len=prompt, pad_lens=beam_pad_lens)
