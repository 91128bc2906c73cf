"""The decoding API: ``Decoder``, ``BeamSearchDecoder`` and
``dynamic_decode`` (port of the reference's ``nn/decode.py``).

The reference compiles the whole decode into one ``lax.scan``; here
``dynamic_decode`` is an eager loop over ``decoder.step``, with the
reference's contract:

- ``max_step_num`` is required, and the stacked outputs always hold
  ``max_step_num + 1`` steps: once every row has finished, the remaining
  steps are frozen pass-through values (for ``BeamSearchDecoder``,
  ``end_token`` with the beam as its own parent, which ``gather_tree``
  collapses).  ``sequence_lengths`` (``return_length=True``) trims them.
- beam selection is by cumulative log-probability, finished beams frozen
  by the ``noend`` mask (only ``end_token`` continues them, at probability
  1).  ``length_penalty=alpha`` ranks candidates by Wu et al.'s (GNMT)
  ``log_prob / ((5 + len) / 6) ** alpha`` while the state carries the raw
  cumulative log-probability; ``alpha = 0`` is the unpenalised selection.
- every top-k is a stable descending sort (``F.top_k_stable``): the lower
  index first among equal scores, as ``jax.lax.top_k`` orders them.

The reference caches its compiled scans by signature and step kwargs; an
eager loop compiles nothing, so that cache has no counterpart here.
"""

from __future__ import annotations

import collections
from typing import Optional

import torch

from .functional import gather_tree, top_k_stable

__all__ = ["Decoder", "BeamSearchDecoder", "dynamic_decode"]

_KINF = 1e9


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _map(fn, *trees):
    """``fn`` over the leaves of same-shaped nests of tuples, lists,
    namedtuples and dicts."""
    t0 = trees[0]
    if _is_namedtuple(t0):
        return type(t0)(*(_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(t0, (tuple, list)):
        return type(t0)(_map(fn, *xs) for xs in zip(*trees))
    if isinstance(t0, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in t0}
    return fn(*trees)


def _leaves(tree) -> list:
    out = []
    _map(out.append, tree)
    return out


class Decoder:
    """The decoding protocol: ``initialize(inits) -> (inputs, states,
    finished)``, ``step(time, inputs, states, **kwargs) -> (outputs,
    states, inputs, finished)``, and an optional ``finalize``."""

    def initialize(self, inits):
        raise NotImplementedError

    def step(self, time, inputs, states, **kwargs):
        raise NotImplementedError

    def finalize(self, outputs, final_states, sequence_lengths):
        raise NotImplementedError

    @property
    def tracks_own_finished(self):
        return False


class BeamSearchDecoder(Decoder):
    """Beam search over an RNN-style ``cell``: ``cell(inputs, states) ->
    (outputs, new_states)`` on the merged ``batch * beam`` rows;
    ``embedding_fn`` maps the chosen ids to the next step's inputs,
    ``output_fn`` the cell's outputs to logits.

    ``length_penalty`` is Wu et al.'s alpha: candidates are selected (and
    ``OutputWrapper.scores`` reported) by ``log_prob / ((5 + len) / 6) **
    alpha``, ``len`` counting the candidate's tokens after this step;
    ``StateWrapper.log_probs`` stays the raw cumulative sum."""

    OutputWrapper = collections.namedtuple(
        "OutputWrapper", ("scores", "predicted_ids", "parent_ids"))
    StateWrapper = collections.namedtuple(
        "StateWrapper", ("cell_states", "log_probs", "finished", "lengths"))

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None,
                 length_penalty: float = 0.0):
        self.cell = cell
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.length_penalty = float(length_penalty)

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size):
        """[batch, ...] -> [batch * beam, ...], each entry repeated
        ``beam_size`` times."""
        return x.repeat_interleave(beam_size, dim=0)

    # -- shape helpers ----------------------------------------------------
    def _split(self, v):
        return v.reshape((-1, self.beam_size) + tuple(v.shape[1:]))

    def _merge(self, v):
        return v.reshape((-1,) + tuple(v.shape[2:]))

    def _expand(self, v):
        return v[:, None].repeat_interleave(self.beam_size, dim=1)

    def _gather(self, v, indices):
        """v [batch, beam, ...], indices [batch, beam]: reorder the beams."""
        idx = indices.reshape(tuple(indices.shape) + (1,) * (v.dim() - 2))
        return v.gather(1, idx.expand(tuple(indices.shape) + tuple(v.shape[2:])))

    # -- protocol ---------------------------------------------------------
    def initialize(self, initial_cell_states):
        leaf = _leaves(initial_cell_states)[0]
        batch, dev, K = leaf.shape[0], leaf.device, self.beam_size
        cell_states = _map(self._expand, initial_cell_states)
        init_inputs = torch.full((batch, K), self.start_token, dtype=torch.int32,
                                 device=dev)
        log_probs = torch.tensor([[0.0] + [-_KINF] * (K - 1)], device=dev).repeat(batch, 1)
        finished = torch.zeros((batch, K), dtype=torch.bool, device=dev)
        lengths = torch.zeros((batch, K), dtype=torch.int32, device=dev)
        if self.embedding_fn is not None:
            init_inputs = self.embedding_fn(init_inputs)
        return (init_inputs,
                self.StateWrapper(cell_states, log_probs, finished, lengths),
                finished)

    def step(self, time, inputs, states, **kwargs):
        K = self.beam_size
        outs, next_cell = self.cell(_map(self._merge, inputs),
                                    _map(self._merge, states.cell_states), **kwargs)
        outs = _map(self._split, outs)
        next_cell = _map(self._split, next_cell)
        if self.output_fn is not None:
            outs = self.output_fn(outs)
        logits = outs.float()                       # [batch, beam, vocab]
        batch, _, V = logits.shape

        step_log_probs = torch.log_softmax(logits, dim=-1)
        # finished beams may only continue with end_token, at probability 1
        noend = torch.full((V,), -_KINF, device=logits.device)
        noend[self.end_token] = 0.0
        step_log_probs = torch.where(states.finished[:, :, None], noend, step_log_probs)
        log_probs = step_log_probs + states.log_probs[:, :, None]
        raw = log_probs.reshape(batch, K * V)
        if self.length_penalty:
            # Wu et al. (2016) eq. 14 at the candidate's length after this
            # step (a finished beam stops growing through the noend mask)
            cand_len = states.lengths + (~states.finished).to(torch.int32)
            lp = ((5.0 + cand_len.float()) / 6.0) ** self.length_penalty
            scores = (log_probs / lp[:, :, None]).reshape(batch, K * V)
        else:
            scores = raw
        topk_scores, topk_idx = top_k_stable(scores, K)
        beam_idx = topk_idx // V
        token_idx = (topk_idx % V).to(torch.int32)
        # the state carries the RAW cumulative log-probs: the penalty
        # re-ranks, it never accumulates
        next_log_probs = raw.gather(1, topk_idx)
        next_cell = _map(lambda v: self._gather(v, beam_idx), next_cell)
        next_finished = self._gather(states.finished, beam_idx)
        next_lengths = self._gather(states.lengths, beam_idx)
        next_lengths = next_lengths + (~next_finished).to(torch.int32)
        next_finished = next_finished | (token_idx == self.end_token)

        output = self.OutputWrapper(topk_scores, token_idx, beam_idx.to(torch.int32))
        new_state = self.StateWrapper(next_cell, next_log_probs, next_finished,
                                      next_lengths)
        next_inputs = (token_idx if self.embedding_fn is None
                       else self.embedding_fn(token_idx))
        return output, new_state, next_inputs, next_finished

    def finalize(self, outputs, final_states, sequence_lengths):
        """Back-trace the beam tree (``F.gather_tree``): the predicted ids
        [T, batch, beam], each beam's whole sequence."""
        return gather_tree(outputs.predicted_ids, outputs.parent_ids), final_states

    @property
    def tracks_own_finished(self):
        return True


def dynamic_decode(decoder: Decoder, inits=None,
                   max_step_num: Optional[int] = None,
                   output_time_major: bool = False, impute_finished: bool = False,
                   is_test: bool = False, return_length: bool = False,
                   **kwargs):
    """Run ``decoder`` for ``max_step_num + 1`` steps.  Returns
    ``(final_outputs, final_states)`` plus ``sequence_lengths`` when
    ``return_length=True``; outputs are batch-major unless
    ``output_time_major``.  ``kwargs`` go to every ``decoder.step``."""
    if max_step_num is None:
        raise ValueError(
            "dynamic_decode needs a static bound: pass max_step_num (the "
            "outputs hold max_step_num + 1 steps)")
    steps = int(max_step_num) + 1

    inputs, states, finished = decoder.initialize(inits)
    lengths = torch.zeros(finished.shape, dtype=torch.int32, device=finished.device)
    outputs = []
    for t in range(steps):
        outs, next_states, next_inputs, next_fin = decoder.step(
            torch.tensor(t, dtype=torch.int32), inputs, states, **kwargs)
        if not decoder.tracks_own_finished:
            next_fin = next_fin | finished
        if impute_finished:   # carry the old state through finished rows
            def keep(new, old, fin=finished):
                m = fin.reshape(tuple(fin.shape) + (1,) * (new.dim() - fin.dim()))
                return torch.where(m, old, new)
            next_states = _map(keep, next_states, states)
        lengths = lengths + (~finished).to(torch.int32)
        outputs.append(outs)
        inputs, states, finished = next_inputs, next_states, next_fin
    outputs = _map(lambda *xs: torch.stack(xs), *outputs)   # [T, ...]

    if hasattr(decoder, "finalize") and not is_test:
        try:
            outputs, states = decoder.finalize(outputs, states, lengths)
        except NotImplementedError:
            pass
    if not output_time_major:
        outputs = _map(lambda v: v.transpose(0, 1), outputs)
    if return_length:
        return outputs, states, lengths
    return outputs, states
