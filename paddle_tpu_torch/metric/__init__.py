"""Evaluation metrics with paddle's streaming API (port of the
reference's ``metric/__init__.py``; paddle's ``python/paddle/metric/
metrics.py``: ``Metric`` `:34`, ``Accuracy`` `:183`, ``Precision`` `:333`,
``Recall`` `:462`, ``Auc`` `:577`, ``accuracy`` `:745`).

The streaming metrics are the reference's, on numpy on the host: a batch's
predictions and labels (tensors on any device, arrays or lists) are read
to numpy, and the counts and histograms accumulate there.  The functional
``accuracy`` runs in torch on the tensors' device.
"""

from __future__ import annotations

import abc
from typing import Optional, Sequence, Union

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, np.ndarray):
        return x
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


class Metric(metaclass=abc.ABCMeta):
    """Streaming metric: ``compute`` (optional preprocessing of a batch) →
    ``update`` (host accumulation) → ``accumulate`` (read) → ``reset``."""

    @abc.abstractmethod
    def reset(self):
        raise NotImplementedError(
            f"function 'reset' not implemented in {self.__class__.__name__}.")

    @abc.abstractmethod
    def update(self, *args):
        raise NotImplementedError(
            f"function 'update' not implemented in {self.__class__.__name__}.")

    @abc.abstractmethod
    def accumulate(self):
        raise NotImplementedError(
            f"function 'accumulate' not implemented in {self.__class__.__name__}.")

    @abc.abstractmethod
    def name(self):
        raise NotImplementedError(
            f"function 'name' not implemented in {self.__class__.__name__}.")

    def compute(self, *args):
        """Identity by default; subclasses map (pred, label, ...) to the
        host arrays ``update`` consumes (on numpy, on the host)."""
        return args


class Accuracy(Metric):
    """Top-k accuracy over a stream of (pred, label) batches."""

    def __init__(self, topk: Union[int, Sequence[int]] = (1,), name: Optional[str] = None,
                 *args, **kwargs):
        super().__init__()
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._init_name(name)
        self.reset()

    def compute(self, pred, label, *args):
        """Per-sample hit-at-rank matrix: bool [N, maxk], column j True iff
        the label is exactly the rank-j prediction (reference
        `metrics.py:246` format — at most one True per row; ``update`` sums
        over the first k columns). One-hot / soft labels (last dim > 1) are
        argmax-decoded as in the reference."""
        pred_np = _to_numpy(pred)
        label_np = _to_numpy(label)
        pred2d = pred_np.reshape(-1, pred_np.shape[-1])
        if label_np.ndim == pred_np.ndim and label_np.shape[-1] > 1:
            label_np = np.argmax(label_np, axis=-1)  # one-hot / soft labels
        elif label_np.ndim and label_np.shape[-1] == 1:
            label_np = label_np[..., 0]
        label_flat = label_np.reshape(-1)
        # top-maxk indices, best first (argpartition: avoid full-vocab sort)
        if self.maxk < pred2d.shape[-1]:
            part = np.argpartition(-pred2d, self.maxk - 1, axis=-1)[:, :self.maxk]
            order = np.argsort(np.take_along_axis(-pred2d, part, axis=-1), axis=-1)
            topi = np.take_along_axis(part, order, axis=-1)
        else:
            topi = np.argsort(-pred2d, axis=-1)[:, :self.maxk]
        return topi == label_flat[:, None]

    def update(self, correct, *args):
        correct = _to_numpy(correct)
        accs = []
        for i, k in enumerate(self.topk):
            num_corrects = correct[:, :k].sum()
            num_samples = correct.shape[0]
            accs.append(float(num_corrects) / num_samples if num_samples else 0.0)
            self.total[i] += num_corrects
            self.count[i] += num_samples
        return accs[0] if len(self.topk) == 1 else accs

    def reset(self):
        self.total = [0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def accumulate(self):
        res = [float(t) / c if c > 0 else 0.0 for t, c in zip(self.total, self.count)]
        return res[0] if len(self.topk) == 1 else res

    def _init_name(self, name):
        name = name or "acc"
        if self.maxk != 1:
            self._name = [f"{name}_top{k}" for k in self.topk]
        else:
            self._name = [name]

    def name(self):
        return self._name


class Precision(Metric):
    """Binary precision: tp / (tp + fp). ``preds`` are probabilities (of the
    positive class) or logits>0.5-style scores; threshold fixed at 0.5 as in
    the reference."""

    def __init__(self, name: str = "precision", *args, **kwargs):
        super().__init__()
        self.tp = 0
        self.fp = 0
        self._name = name

    def update(self, preds, labels):
        preds = _to_numpy(preds).reshape(-1)
        labels = _to_numpy(labels).reshape(-1)
        if preds.shape != labels.shape:
            raise ValueError("Precision.update: preds/labels shape mismatch")
        # reference rounding: floor(pred + 0.5), rint(label) — 0.5 is positive
        pred_pos = np.floor(preds + 0.5).astype(np.int64) == 1
        pos = np.rint(labels).astype(np.int64) == 1
        self.tp += int(np.sum(pred_pos & pos))
        self.fp += int(np.sum(pred_pos & ~pos))

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        denom = self.tp + self.fp
        return float(self.tp) / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    """Binary recall: tp / (tp + fn)."""

    def __init__(self, name: str = "recall", *args, **kwargs):
        super().__init__()
        self.tp = 0
        self.fn = 0
        self._name = name

    def update(self, preds, labels):
        preds = _to_numpy(preds).reshape(-1)
        labels = _to_numpy(labels).reshape(-1)
        if preds.shape != labels.shape:
            raise ValueError("Recall.update: preds/labels shape mismatch")
        pred_pos = np.floor(preds + 0.5).astype(np.int64) == 1
        actual_pos = np.rint(labels).astype(np.int64) == 1
        self.tp += int(np.sum(pred_pos & actual_pos))
        self.fn += int(np.sum(~pred_pos & actual_pos))

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        denom = self.tp + self.fn
        return float(self.tp) / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """ROC AUC via histogram buckets (streaming), matching the reference's
    thresholded-bucket algorithm (`metrics.py:577`, num_thresholds buckets)."""

    def __init__(self, curve: str = "ROC", num_thresholds: int = 4095,
                 name: str = "auc", *args, **kwargs):
        super().__init__()
        if curve != "ROC":
            raise NotImplementedError("only ROC AUC is supported (as in practice "
                                      "the reference's PR curve path is unused)")
        self._num_thresholds = num_thresholds
        self._name = name
        self.reset()

    def update(self, preds, labels):
        """``preds``: [N, 2] class probabilities (paddle convention: column 1
        is the positive-class prob) or [N] positive-class scores."""
        preds = _to_numpy(preds)
        labels = _to_numpy(labels).reshape(-1)
        pos_prob = preds[:, 1] if preds.ndim == 2 else preds.reshape(-1)
        idx = np.clip((pos_prob * self._num_thresholds).astype(np.int64),
                      0, self._num_thresholds)
        pos_mask = labels == 1
        np.add.at(self._stat_pos, idx[pos_mask], 1)
        np.add.at(self._stat_neg, idx[~pos_mask], 1)

    def reset(self):
        self._stat_pos = np.zeros(self._num_thresholds + 1, dtype=np.int64)
        self._stat_neg = np.zeros(self._num_thresholds + 1, dtype=np.int64)

    @staticmethod
    def trapezoid_area(x1, x2, y1, y2):
        return abs(x1 - x2) * (y1 + y2) / 2.0

    def accumulate(self):
        tot_pos = 0.0
        tot_neg = 0.0
        area = 0.0
        for i in range(self._num_thresholds, -1, -1):
            new_pos = tot_pos + self._stat_pos[i]
            new_neg = tot_neg + self._stat_neg[i]
            area += self.trapezoid_area(tot_neg, new_neg, tot_pos, new_pos)
            tot_pos, tot_neg = new_pos, new_neg
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        return area / (tot_pos * tot_neg)

    def name(self):
        return self._name


def accuracy(input, label, k: int = 1, correct=None, total=None, name=None):
    """The fraction of samples whose label is among the top ``k``
    predictions (reference ``metrics.py:745``), a shape-[1] f32 tensor on
    ``input``'s device.  Given ``correct`` and ``total`` tensors, they
    receive the batch's hit count and sample count (int32, shape [1])."""
    pred = torch.as_tensor(input)
    lab = torch.as_tensor(label, device=pred.device)
    if lab.dim() == pred.dim() and lab.shape[-1] == 1:
        lab = lab[..., 0]
    topi = pred.topk(k, dim=-1).indices
    hit = (topi == lab[..., None]).any(dim=-1)
    n_correct = hit.sum(dtype=torch.int32).reshape(1)
    n_total = torch.tensor([hit.numel()], dtype=torch.int32, device=pred.device)
    for out, value in ((correct, n_correct), (total, n_total)):
        if isinstance(out, torch.Tensor):
            out.data = value
    return n_correct.float() / hit.numel()
