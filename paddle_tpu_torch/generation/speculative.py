"""Speculative decoding: draft k tokens cheaply, verify them with ONE
target-model forward, emit every token the target agrees with (port of the
reference's ``generation/speculative.py``).

A drafter proposes ``k`` tokens; the target runs once over ``[t_last,
d_1..d_k]`` at positions ``p..p+k``, and the longest prefix of drafts that
equals the target's own greedy argmax is accepted, plus the target's next
token: between 1 and ``k+1`` tokens for one read of the weights.  Greedy
output is token-exact by construction: a draft is consumed only where it
equals the argmax the serial decode would have taken.  ``do_sample=True``
accepts by rejection sampling (accept ``d`` with probability ``min(1,
p(d)/q(d))``, else sample ``max(p - q, 0)``), exact in distribution.

A rejected draft's k/v stays in the cache past the emitted tokens, but a
query at position ``x`` attends only columns ``<= x``, and the slot at
``x`` is rewritten by the step that queries it first.

The host-side parts (:class:`SpecConfig`, :class:`AdaptiveK`,
:class:`NGramDrafter`, :func:`rejection_sample_step`, the acceptance loop
and its ``np.random.default_rng(seed)`` stream) are the reference's numpy
code.  The model drafters' single-token step is one eager forward into
their own contiguous cache, so it runs the decode kernel (B6) at s = 1 on
the card; :func:`speculative_generate`'s prefill runs the flash kernel (B3)
and its verify window the dense grouped-head path of ``cached_attention``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = ["SpecConfig", "NGramDrafter", "ShallowExitDrafter",
           "DraftModelDrafter", "speculative_generate",
           "rejection_sample_step", "AdaptiveK"]


# --------------------------------------------------------------------------
# config / adaptation
# --------------------------------------------------------------------------
@dataclass
class SpecConfig:
    """Speculation knobs shared by the standalone loop and the serving
    engine.  ``k`` is the MAX draft length; with ``adaptive=True`` the EMA
    of the measured acceptance rate shrinks the per-step draft length (the
    verify width stays ``k+1``; only the valid-token count changes).
    ``drafter`` is ``"ngram"`` or a zero-arg factory returning a fresh
    drafter."""

    k: int = 4
    adaptive: bool = True
    drafter: Union[str, Callable[[], object]] = "ngram"
    ngram_max: int = 4
    ema_decay: float = 0.7

    def make_drafter(self):
        if callable(self.drafter):
            return self.drafter()
        if self.drafter == "ngram":
            return NGramDrafter(max_ngram=self.ngram_max)
        raise ValueError(f"unknown drafter {self.drafter!r}")


class AdaptiveK:
    """EMA acceptance-rate → draft-length controller.  Optimistic start
    (full k); a cold streak decays toward 1-token drafts, recovery grows
    back — all host-side, the verify width never changes."""

    def __init__(self, k_max: int, adaptive: bool = True,
                 decay: float = 0.7):
        self.k_max = max(int(k_max), 1)
        self.adaptive = bool(adaptive)
        self.decay = float(decay)
        self.ema = 1.0

    def k(self) -> int:
        if not self.adaptive:
            return self.k_max
        return max(1, min(self.k_max, int(round(self.ema * self.k_max))))

    def update(self, accepted: int, proposed: int) -> None:
        if proposed <= 0:
            return
        rate = accepted / proposed
        self.ema = self.decay * self.ema + (1.0 - self.decay) * rate


# --------------------------------------------------------------------------
# drafters
# --------------------------------------------------------------------------
class NGramDrafter:
    """Propose the continuation that followed the most recent earlier
    occurrence of the context's longest matching suffix (up to
    ``max_ngram`` tokens).  Host-side list matching, no model cost."""

    def __init__(self, max_ngram: int = 4):
        self.max_ngram = max(int(max_ngram), 1)
        self._ctx: List[int] = []
        self.probs: Optional[List[Optional[np.ndarray]]] = None

    def begin(self, context: Sequence[int]) -> None:
        self._ctx = [int(t) for t in context]

    def observe(self, tokens: Sequence[int]) -> None:
        self._ctx.extend(int(t) for t in tokens)

    def propose(self, k: int, temperature: float = 0.0,
                rng=None) -> List[int]:
        self.probs = None
        ctx, n = self._ctx, len(self._ctx)
        if k <= 0 or n < 2:
            return []
        for L in range(min(self.max_ngram, n - 1), 0, -1):
            suffix = ctx[n - L:]
            for start in range(n - L - 1, -1, -1):
                if ctx[start:start + L] == suffix:
                    cont = ctx[start + L:start + L + k]
                    if cont:
                        return list(cont)
        return []


class _ModelDrafterBase:
    """Shared machinery of the model-backed drafters: a single-row
    incremental decode (``_step(tok, pos) -> logits``) over a contiguous
    cache of their own.  ``propose`` rolls draft steps through the SAME
    cache; the stale draft k/v it leaves is overwritten by the next
    ``observe``/``propose`` writes before any query can attend it."""

    def __init__(self):
        self._caches = None
        self._pos = 0
        self._last: Optional[np.ndarray] = None
        self.probs: Optional[List[Optional[np.ndarray]]] = None

    # subclasses: self._capacity, _fresh_caches(), _step(tok, pos)
    def begin(self, context: Sequence[int]) -> None:
        self._caches = self._fresh_caches()
        self._pos = 0
        self._last = None
        self.observe(context)

    def observe(self, tokens: Sequence[int]) -> None:
        for t in tokens:
            if self._pos >= self._capacity:
                self._last = None
                return
            self._last = self._step(int(t), self._pos)
            self._pos += 1

    def propose(self, k: int, temperature: float = 0.0,
                rng=None) -> List[int]:
        self.probs = None
        if k <= 0 or self._last is None:
            return []
        toks: List[int] = []
        probs: List[Optional[np.ndarray]] = []
        logits, pos = self._last, self._pos
        for i in range(k):
            lg = np.asarray(logits, np.float32)
            if temperature > 0.0 and rng is not None:
                p = _softmax_np(lg / max(temperature, 1e-6))
                t = int(rng.choice(p.shape[-1], p=p))
                probs.append(p)
            else:
                t = int(np.argmax(lg))
                probs.append(None)
            toks.append(t)
            if i < k - 1:
                if pos >= self._capacity:
                    break
                logits = self._step(t, pos)     # scratch write; see class doc
                pos += 1
        self.probs = probs
        return toks

    def _token(self, tok: int) -> torch.Tensor:
        return torch.tensor([[tok]], dtype=torch.long, device=self._device)


def _capacity(n: int) -> int:
    return -(-int(n) // 8) * 8   # a multiple of 8, as the reference's caches


class DraftModelDrafter(_ModelDrafterBase):
    """External draft model: any causal LM of the port with the
    ``kv_cache``/``position_offset`` forward contract, stepped one token at
    a time into its own cache."""

    def __init__(self, draft_model, capacity: int):
        super().__init__()
        self.model = draft_model
        self._capacity = _capacity(capacity)
        self._device = next(iter(draft_model.parameters())).device

    def _fresh_caches(self):
        return self.model.new_kv_cache(1, self._capacity)

    @torch.inference_mode()
    def _step(self, tok: int, pos: int) -> np.ndarray:
        logits, self._caches = self.model(self._token(tok), kv_cache=self._caches,
                                          position_offset=pos)
        return logits[0, -1].float().cpu().numpy()


class ShallowExitDrafter(_ModelDrafterBase):
    """Self-drafting by early exit: the TARGET model's first
    ``draft_layers`` decoder layers, its final norm and its lm head
    propose; no second model.  Needs a llama-family model (the serving
    engine's contract)."""

    def __init__(self, model, capacity: int, draft_layers: int = 1):
        super().__init__()
        base = getattr(model, "llama", None)
        if base is None or not hasattr(base, "layers"):
            raise TypeError("ShallowExitDrafter needs a llama-family model "
                            "(model.llama.layers); got " + type(model).__name__)
        self.model = model
        self.draft_layers = max(1, min(int(draft_layers), len(base.layers)))
        self._capacity = _capacity(capacity)
        self._device = next(iter(model.parameters())).device

    def _fresh_caches(self):
        return self.model.new_kv_cache(1, self._capacity, layers=self.draft_layers)

    @torch.inference_mode()
    def _step(self, tok: int, pos: int) -> np.ndarray:
        from ..models.llama import apply_rotary_at_positions
        from . import cached_attention

        model = self.model
        base, cfg = model.llama, model.config
        h, kvh, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        cos, sin = base.rope_cos.float(), base.rope_sin.float()
        pos_ids = torch.tensor([[pos]], dtype=torch.int32, device=self._device)
        x = base.embed_tokens(self._token(tok))
        caches = []
        for layer, (ck, cv) in zip(base.layers[:self.draft_layers], self._caches):
            attn = layer.self_attn
            xin = layer.input_layernorm(x)
            q = attn.q_proj(xin).view(1, 1, h, d)
            k = attn.k_proj(xin).view(1, 1, kvh, d)
            v = attn.v_proj(xin).view(1, 1, kvh, d)
            q, k = apply_rotary_at_positions(q, k, cos, sin, pos_ids)
            out, ck, cv = cached_attention(q, k, v, ck, cv, pos)
            caches.append((ck, cv))
            x = x + attn.o_proj(out.reshape(1, 1, h * d))
            x = x + layer.mlp(layer.post_attention_layernorm(x))
        self._caches = caches
        return model._logits(base.norm(x))[0, -1].float().cpu().numpy()


# --------------------------------------------------------------------------
# rejection sampling (temperature > 0)
# --------------------------------------------------------------------------
def _softmax_np(logits: np.ndarray) -> np.ndarray:
    z = np.asarray(logits, np.float64)
    z = z - np.max(z)
    e = np.exp(z)
    return e / e.sum()


def rejection_sample_step(p: np.ndarray, q: Optional[np.ndarray],
                          draft_token: int, rng) -> Tuple[bool, int]:
    """One speculative-sampling acceptance test.  ``p`` is the target
    distribution at this slot, ``q`` the drafter's proposal distribution
    (``None`` = deterministic drafter = one-hot at ``draft_token``).
    Returns ``(accepted, token)``; the emitted token is distributed EXACTLY
    as ``p`` whatever ``q`` is (accept w.p. min(1, p/q), else sample the
    normalized residual ``max(p-q, 0)``)."""
    d = int(draft_token)
    p = np.asarray(p, np.float64)
    if q is None:
        qd = 1.0
        accept_p = min(1.0, float(p[d]) / qd)
        if rng.random() < accept_p:
            return True, d
        resid = p.copy()
        resid[d] = max(p[d] - 1.0, 0.0)
    else:
        q = np.asarray(q, np.float64)
        qd = max(float(q[d]), 1e-20)
        if rng.random() < min(1.0, float(p[d]) / qd):
            return True, d
        resid = np.maximum(p - q, 0.0)
    tot = resid.sum()
    if tot <= 0.0:                      # q covers p exactly: sample p
        resid, tot = p, p.sum()
    resid = resid / tot
    return False, int(rng.choice(resid.shape[0], p=resid))


# --------------------------------------------------------------------------
# standalone loop
# --------------------------------------------------------------------------
@torch.inference_mode()
def speculative_generate(model, input_ids, max_new_tokens: int = 64, *,
                         drafter: Union[str, object, Callable] = "ngram",
                         k: int = 4, adaptive: bool = True,
                         eos_token_id: Optional[int] = None,
                         pad_token_id: Optional[int] = None,
                         do_sample: bool = False, temperature: float = 1.0,
                         seed: int = 0):
    """Speculative decoding over a contiguous static cache, row by row.
    Greedy (``do_sample=False``) output is token-exact against
    ``model.generate``; sampling is exact in distribution.

    Returns ``(ids, stats)``: ``ids`` int32 ``[batch, max_new_tokens]`` on
    the model's device (eos-latched rows padded with ``pad_token_id``,
    default eos, else 0), and ``stats`` with ``proposed`` / ``accepted`` /
    ``acceptance_rate`` / ``verify_steps`` / ``tokens`` / ``rows`` /
    ``effective_tokens_per_step``."""
    device = next(iter(model.parameters())).device
    ids = torch.as_tensor(input_ids.detach().cpu().numpy() if torch.is_tensor(input_ids)
                          else np.asarray(input_ids)).long()
    if ids.dim() != 2:
        raise ValueError(f"input_ids must be [batch, seq], got {tuple(ids.shape)}")
    b, prompt = int(ids.shape[0]), int(ids.shape[1])
    max_new = int(max_new_tokens)
    if max_new < 1:
        raise ValueError("max_new_tokens must be >= 1")
    k = max(1, int(k))
    # the verify forward writes its FULL k+1 window every call (padded slots
    # included), so the cache must hold pos + k + 1 slots and every queried
    # position must stay inside the rope table
    max_pos = model.config.max_position_embeddings
    spare = max_pos - (prompt + max_new)
    if spare < 1:
        raise ValueError(
            f"speculative decoding needs prompt + max_new_tokens + 1 <= "
            f"max_position_embeddings ({max_pos}) for the draft overhang; "
            f"got {prompt} + {max_new}")
    k = min(k, spare)
    total = _capacity(prompt + max_new + k)
    eos = None if eos_token_id is None else int(eos_token_id)
    pad = eos if pad_token_id is None else int(pad_token_id)
    if pad is None:
        pad = 0
    S = k + 1

    def _make_drafter():
        if callable(drafter) and not hasattr(drafter, "propose"):
            return drafter()
        if isinstance(drafter, str):
            return SpecConfig(drafter=drafter).make_drafter()
        return drafter                  # single instance, re-begun per row

    rng = np.random.default_rng(seed)
    out = np.full((b, max_new), pad, np.int32)
    stats = {"proposed": 0, "accepted": 0, "verify_steps": 0, "tokens": 0,
             "rows": []}
    temp = float(temperature) if do_sample else 0.0

    for row in range(b):
        dr = _make_drafter()
        ctrl = AdaptiveK(k, adaptive)
        row_ids = ids[row:row + 1].to(device)
        dr.begin([int(t) for t in ids[row]])
        caches = model.new_kv_cache(1, total)
        logits, caches = model(row_ids, kv_cache=caches, position_offset=0)
        lg0 = logits[0, -1].float().cpu().numpy()
        if do_sample:
            p0 = _softmax_np(lg0 / max(temp, 1e-6))
            t0 = int(rng.choice(p0.shape[0], p=p0))
        else:
            t0 = int(np.argmax(lg0))
        generated = [t0]
        dr.observe([t0])
        r_prop = r_acc = r_steps = 0
        while len(generated) < max_new and not (eos is not None
                                                and generated[-1] == eos):
            pos = prompt + len(generated) - 1
            k_r = max(min(ctrl.k(), max_new - len(generated) - 1), 0)
            drafts = list(dr.propose(k_r, temperature=temp, rng=rng))[:k_r]
            q_probs = list(getattr(dr, "probs", None) or [])
            tokens = np.zeros((1, S), np.int64)
            tokens[0, 0] = generated[-1]
            tokens[0, 1:1 + len(drafts)] = drafts
            logits, caches = model(torch.as_tensor(tokens, device=device),
                                   kv_cache=caches, position_offset=pos)
            logits = logits[0].float().cpu().numpy()    # [S, V]
            n_valid = 1 + len(drafts)
            emitted: List[int] = []
            for i in range(n_valid):
                if do_sample:
                    p = _softmax_np(logits[i] / max(temp, 1e-6))
                    if i < len(drafts):
                        q = q_probs[i] if i < len(q_probs) else None
                        ok, tok = rejection_sample_step(p, q, drafts[i], rng)
                    else:
                        ok, tok = False, int(rng.choice(p.shape[0], p=p))
                else:
                    tok = int(np.argmax(logits[i]))
                    ok = i < len(drafts) and tok == drafts[i]
                emitted.append(tok)
                full = len(generated) + len(emitted) >= max_new
                if (eos is not None and tok == eos) or full or not ok:
                    break
            generated.extend(emitted)
            dr.observe(emitted)
            acc = max(len(emitted) - 1, 0)
            ctrl.update(acc, len(drafts))
            r_prop += len(drafts)
            r_acc += acc
            r_steps += 1
        out[row, :len(generated)] = generated[:max_new]
        stats["proposed"] += r_prop
        stats["accepted"] += r_acc
        stats["verify_steps"] += r_steps
        stats["tokens"] += len(generated)
        stats["rows"].append({
            "tokens": len(generated), "proposed": r_prop,
            "accepted": r_acc, "verify_steps": r_steps})
    stats["acceptance_rate"] = (stats["accepted"] / stats["proposed"]
                                if stats["proposed"] else None)
    total_steps = stats["verify_steps"] + b     # + each row's prefill token
    stats["effective_tokens_per_step"] = stats["tokens"] / max(total_steps, 1)
    return torch.as_tensor(out, device=device), stats
