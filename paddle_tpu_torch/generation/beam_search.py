"""Beam search over a cached decode step (port of the reference's
``generation/beam_search.py``).

The reference runs the whole search as one ``lax.scan``; here it is an
eager loop over the new tokens, with the same carry: the step's
log-probabilities, the caches, the running beams (``run_ids``,
``run_scores``), the bank of finished hypotheses (``bank_ids``,
``bank_scores``) and the per-row ``done`` latch.  Semantics, as pinned by
the reference's brute-force test:

- running beams are the ``K`` best non-eos continuations, by cumulative
  log-probability, from the ``2K`` best (beam, token) pairs;
- a continuation ending in eos is a candidate hypothesis scored
  ``cum_logprob / (t + 1) ** length_penalty`` and merged into the row's
  top-``K`` bank;
- a row stops when its bank is full and ``early_stopping`` is set, or no
  running beam can still beat its worst hypothesis;
- at the end, running beams fill an under-full bank at the maximum length,
  finished hypotheses ranking first.

Every score is f32 and computed in the reference's order, so the roundings
at ``-1e9`` (dead beams) agree.  ``jax.lax.top_k`` puts the lower index
first among equal values, and the search meets many exact ties (dead beams
share beam 0's logits at step 0; the empty bank is all ``-1e9``), so every
top-k here is a stable descending sort (``F.top_k_stable``), never
``torch.topk``, whose tie order is unspecified on the card.

Once every row is done the carry is frozen, so the loop stops there; and
the last step's forward, whose logits nothing reads, is skipped.  Neither
changes the result.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..nn.functional import top_k_stable as _top_k

__all__ = ["beam_search_loop"]

_NEG = -1e9   # exact in f32


def _pow(t: int, lp: float) -> torch.Tensor:
    """``float32(t) ** lp`` in f32."""
    return torch.tensor(float(t), dtype=torch.float32).pow(lp)


def beam_search_loop(step_fn: Callable, caches, first_logits,
                     *, num_beams: int, max_new: int, eos: int, pad: int,
                     length_penalty: float = 1.0, early_stopping: bool = False,
                     min_new: int = 0, prompt_len: int = 0,
                     pad_lens=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the beam search.

    ``step_fn(tok [b*K, 1], caches, offset, pad_lens [b*K] or None) ->
    (logits [b*K, V], caches)`` is one cached decode step; ``caches`` (a
    list of per-layer ``(k, v)``) are already tiled to ``b*K`` rows,
    beam-fastest (row = batch * K + beam).  ``first_logits`` [b, V] are the
    prefill's logits at the last prompt position.  Returns ``(ids [b, K,
    max_new] int32, scores [b, K] f32)``, best first in each row; the
    positions after a hypothesis's eos hold ``pad``."""
    K = int(num_beams)
    b, V = first_logits.shape
    if K < 1:
        raise ValueError("num_beams must be >= 1")
    kk = min(2 * K, K * V)  # candidate pool (a vocabulary under 2K degrades)
    lp = float(length_penalty)
    dev = first_logits.device
    f32 = torch.float32

    logp = torch.log_softmax(first_logits.float(), dim=-1)
    # step 0: only beam 0 is alive, and every beam shares the prefill logits
    logp = logp[:, None, :].expand(b, K, V)
    run_scores = torch.full((b, K), _NEG, dtype=f32, device=dev)
    run_scores[:, 0] = 0.0
    run_ids = torch.full((b, K, max_new), pad, dtype=torch.int32, device=dev)
    bank_ids = torch.full((b, K, max_new), pad, dtype=torch.int32, device=dev)
    bank_scores = torch.full((b, K), _NEG, dtype=f32, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    rows = torch.arange(b, device=dev)[:, None]
    eos_col = torch.arange(V, device=dev) == eos

    for t in range(max_new):
        if eos >= 0 and t < min_new:
            logp = torch.where(eos_col, _NEG, logp)
        cand = (run_scores[:, :, None] + logp).reshape(b, K * V)
        top_scores, top_idx = _top_k(cand, kk)                 # [b, kk]
        beam = top_idx // V
        tok = (top_idx % V).to(torch.int32)
        cand_ids = run_ids.gather(1, beam[:, :, None].expand(b, kk, max_new))
        cand_ids[:, :, t] = tok
        is_eos = tok == eos if eos >= 0 else torch.zeros_like(tok, dtype=torch.bool)

        # bank merge: eos candidates length-normalised at t + 1, only where
        # the candidate is alive (a dead beam's _NEG / (t+1)^lp can clear
        # the bank_full threshold at large t)
        pen = top_scores / _pow(t + 1, lp)
        eos_pen = torch.where((top_scores > _NEG / 2) & is_eos, pen, _NEG)
        merged_scores = torch.cat([bank_scores, eos_pen], dim=1)
        merged_ids = torch.cat([bank_ids, cand_ids], dim=1)
        new_bank_scores, sel = _top_k(merged_scores, K)
        new_bank_ids = merged_ids.gather(1, sel[:, :, None].expand(b, K, max_new))
        bank_scores = torch.where(done[:, None], bank_scores, new_bank_scores)
        bank_ids = torch.where(done[:, None, None], bank_ids, new_bank_ids)

        # running frontier: the best K non-eos continuations
        run_pool = torch.where(is_eos, _NEG, top_scores)
        new_run_scores, rsel = _top_k(run_pool, K)            # [b, K]
        new_run_ids = cand_ids.gather(1, rsel[:, :, None].expand(b, K, max_new))
        new_tok = tok.gather(1, rsel)
        parent = beam.gather(1, rsel)
        run_scores = torch.where(done[:, None], run_scores, new_run_scores)
        run_ids = torch.where(done[:, None, None], run_ids, new_run_ids)

        # the stop rule, per row, latched
        bank_full = bank_scores[:, K - 1] > _NEG / 2
        if early_stopping:
            newly_done = bank_full
        else:
            highest = run_scores[:, 0] / _pow(t + 1, lp)
            newly_done = bank_full & (bank_scores[:, K - 1] >= highest)
        done = done | newly_done
        if t == max_new - 1 or bool(done.all()):
            break   # the carry is frozen, or the next logits go unread

        # the caches follow their beams: row bi*K + ki takes parent
        # bi*K + p; index_select makes fresh tensors, so the decode step's
        # in-place append aliases nothing still read
        flat_parent = (rows * K + parent).reshape(b * K)
        caches = [(ck.index_select(0, flat_parent), cv.index_select(0, flat_parent))
                  for ck, cv in caches]
        logits, caches = step_fn(new_tok.reshape(b * K, 1).long(), caches,
                                 prompt_len + t, pad_lens)
        logp = torch.log_softmax(logits.reshape(b, K, V).float(), dim=-1)

    # fill under-full banks from the running beams, normalised at the
    # maximum length; finished hypotheses always outrank running ones
    run_pen = run_scores / _pow(max_new, lp)
    finished_key = bank_scores + torch.where(bank_scores > _NEG / 2, 1e6, 0.0)
    running_key = torch.where(run_scores > _NEG / 2, run_pen, _NEG)
    all_keys = torch.cat([finished_key, running_key], dim=1)
    all_ids = torch.cat([bank_ids, run_ids], dim=1)
    all_scores = torch.cat([bank_scores, run_pen], dim=1)
    _, sel = _top_k(all_keys, K)
    out_ids = all_ids.gather(1, sel[:, :, None].expand(b, K, max_new))
    out_scores = all_scores.gather(1, sel)
    return out_ids, out_scores
