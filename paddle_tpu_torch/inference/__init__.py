"""The model-backed predictor: ``Predictor.from_model(model)`` with
``generate`` and ``generate_batch`` (port of the reference's
``inference/__init__.py:114-227``).  The handle-based predictor over a saved
StableHLO program is not ported.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

__all__ = ["Predictor"]


class Predictor:
    """Serves a live causal-LM module through its KV-cache decode loop."""

    def __init__(self, model):
        if getattr(model, "generate", None) is None:
            raise TypeError("Predictor serves a model with a generate() method")
        self._layer = model

    @classmethod
    def from_model(cls, model) -> "Predictor":
        """Serve a live model (weights already loaded)."""
        return cls(model)

    def generate(self, input_ids, **kwargs) -> Tuple[np.ndarray, np.ndarray]:
        """``model.generate`` pass-through; returns (ids, scores) as numpy."""
        ids, scores = self._layer.generate(input_ids, **kwargs)
        return ids.cpu().numpy(), scores.cpu().numpy()

    def generate_batch(self, prompts, max_batch: int = 8,
                       **kwargs) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Serve RAGGED prompts: group them into power-of-two length buckets,
        left-pad each group to its bucket (every row decodes exactly as if
        unpadded), fill partial batches up to ``max_batch`` rows with copies
        of the first, and let under-full buckets merge upward into the next
        one.  ``prompts``: 1-D int sequences.  Returns per-prompt
        ``(ids, scores)`` numpy pairs in input order."""
        arrs = [np.asarray(p, np.int32).reshape(-1) for p in prompts]
        if not arrs:
            return []
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        # cap the bucket at the position budget, like generate(bucket="pow2")
        max_new = int(kwargs.get("max_new_tokens", 64))
        cap = getattr(getattr(self._layer, "config", None),
                      "max_position_embeddings", None)
        buckets: Dict[int, List[int]] = {}
        for i, a in enumerate(arrs):
            blen = max(16, 1 << (max(len(a), 1) - 1).bit_length())
            if cap is not None:
                blen = max(min(blen, cap - max_new), len(a))
            buckets.setdefault(blen, []).append(i)
        results: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}

        def dispatch(chunk, blen):
            rows, mask = [], []
            for i in chunk:
                a = arrs[i]
                rows.append(np.concatenate([np.zeros(blen - len(a), np.int32), a]))
                mask.append(np.concatenate([np.zeros(blen - len(a), np.int32),
                                            np.ones(len(a), np.int32)]))
            while len(rows) < max_batch:  # dummy rows keep the batch full
                rows.append(rows[0])
                mask.append(mask[0])
            ids, scores = self.generate(np.stack(rows),
                                        attention_mask=np.stack(mask), **kwargs)
            for r, i in enumerate(chunk):
                results[i] = (ids[r], scores[r])

        # an under-full chunk rides up into the next bucket (its rows just
        # left-pad further), so many distinct lengths still run full batches
        order = sorted(buckets)
        pending: List[int] = []
        for j, blen in enumerate(order):
            pending.extend(buckets[blen])
            while len(pending) >= max_batch:
                dispatch(pending[:max_batch], blen)
                pending = pending[max_batch:]
            if pending and j + 1 == len(order):
                dispatch(pending, blen)
                pending = []
        return [results[i] for i in range(len(arrs))]
