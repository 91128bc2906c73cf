"""The declarative train / evaluate / predict driver (port of the
reference's ``distributed/auto_parallel/engine_api.py``; paddle's
``auto_parallel/static/engine.py`` ``Engine``).

``prepare`` builds a ``DistributedTrainStep`` over the hybrid group (the
one set, or by default data parallelism over every visible card through
``fleet.init``); ``fit`` runs it over a ``Dataset`` (through
``DistributedBatchSampler`` and ``DataLoader``) or an iterable of
batches, each batch's last element the label.  ``evaluate`` and
``predict`` run the model in ``torch.no_grad`` with the batch moved to its
device.  As in the reference::

    engine = Engine(model, loss, optimizer, metrics, strategy=strategy)
    engine.fit(train_dataset, epochs=2, batch_size=64)
    engine.evaluate(eval_dataset)

``save`` and ``load`` write and read the distributed checkpoint
(``distributed.checkpoint``), which reshards on load.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from ...metric import Metric

__all__ = ["Engine"]


class Engine:
    def __init__(self, model: Optional[nn.Module] = None, loss=None, optimizer=None,
                 metrics=None, cluster=None, strategy=None):
        self._model = model
        self._loss = loss
        self._optimizer = optimizer
        metrics = metrics or []
        self._metrics = list(metrics) if isinstance(metrics, (list, tuple)) else [metrics]
        for m in self._metrics:
            if not isinstance(m, Metric):
                raise TypeError(f"metrics must be Metric instances, got {type(m)}")
        self._strategy = strategy
        self._train_step = None
        self.history: dict = {"loss": []}

    # -- planning ----------------------------------------------------------
    def _ensure_hcg(self):
        from .. import fleet
        from ..topology import get_hybrid_communicate_group

        hcg = get_hybrid_communicate_group()
        if hcg is None:
            strategy = self._strategy
            if strategy is None:
                # no strategy: data parallelism over every visible card
                strategy = fleet.DistributedStrategy()
                strategy.hybrid_configs = {"dp_degree": -1, "mp_degree": 1,
                                           "pp_degree": 1, "sharding_degree": 1,
                                           "sep_degree": 1}
            fleet.init(is_collective=True, strategy=strategy)
            hcg = get_hybrid_communicate_group()
        return hcg

    def prepare(self, inputs_spec=None, labels_spec=None, main_program=None,
                startup_program=None, mode: str = "train"):
        """Build the distributed step (the reference plans and partitions a
        program here)."""
        if self._model is None or self._loss is None:
            raise RuntimeError("Engine needs model and loss")
        if mode == "train" and self._optimizer is None:
            raise RuntimeError("Engine.prepare(mode='train') needs an optimizer")
        from ..engine import DistributedTrainStep

        hcg = self._ensure_hcg()
        if mode == "train" and self._train_step is None:
            loss_fn = self._loss

            def step_loss(model, *batch):
                *xs, y = batch
                loss = loss_fn(model(*xs), y)
                return loss if isinstance(loss, torch.Tensor) else loss[0]

            self._train_step = DistributedTrainStep(
                self._model, step_loss, self._optimizer, hcg)
        return self

    # -- loops -------------------------------------------------------------
    def _loader(self, data, batch_size, shuffle, collate_fn=None):
        from ...io import DataLoader, Dataset, DistributedBatchSampler

        if data is None or not isinstance(data, Dataset):
            return data
        sampler = DistributedBatchSampler(data, batch_size=batch_size, shuffle=shuffle)
        return DataLoader(data, batch_sampler=sampler, collate_fn=collate_fn)

    def _on_device(self, xs):
        dev = next(iter(self._model.parameters())).device
        return [torch.as_tensor(x, device=dev) for x in xs]

    def fit(self, train_data=None, train_sample_split=None, batch_size: int = 1,
            epochs: int = 1, steps_per_epoch: Optional[int] = None,
            log_freq: int = 10, save_dir: Optional[str] = None,
            save_freq: int = 1, valid_data=None, valid_freq: int = 1,
            collate_fn=None, callbacks=None, verbose: int = 1):
        self.prepare(mode="train")
        if callbacks is not None:
            raise NotImplementedError("Engine callbacks: use hapi.Model for the callback stack")
        loader = self._loader(train_data, batch_size, shuffle=True, collate_fn=collate_fn)
        for epoch in range(epochs):
            losses = []
            for step, batch in enumerate(loader):
                if steps_per_epoch is not None and step >= steps_per_epoch:
                    break
                losses.append(float(self._train_step(*batch)))
                if verbose and step % log_freq == 0:
                    print(f"[auto engine] epoch {epoch} step {step} "
                          f"loss {losses[-1]:.5f}")
            self.history["loss"].append(float(np.mean(losses)) if losses else None)
            if valid_data is not None and (epoch + 1) % valid_freq == 0:
                self.evaluate(valid_data, batch_size=batch_size, verbose=verbose)
            if save_dir is not None and (epoch + 1) % save_freq == 0:
                self.save(f"{save_dir}/epoch{epoch}")
        return self.history

    @torch.no_grad()
    def evaluate(self, valid_data=None, valid_sample_split=None,
                 batch_size: int = 1, steps: Optional[int] = None,
                 log_freq: int = 10, collate_fn=None, callbacks=None,
                 verbose: int = 1) -> dict:
        if callbacks is not None:
            raise NotImplementedError("Engine callbacks: use hapi.Model for the callback stack")
        loader = self._loader(valid_data, batch_size, shuffle=False, collate_fn=collate_fn)
        self._model.eval()
        for m in self._metrics:
            m.reset()
        losses = []
        for step, batch in enumerate(loader):
            if steps is not None and step >= steps:
                break
            *xs, y = self._on_device(batch)
            out = self._model(*xs)
            losses.append(float(self._loss(out, y)))
            for m in self._metrics:
                m.update(*_tup(m.compute(out, y)))
        self._model.train()
        logs = {"loss": float(np.mean(losses)) if losses else None}
        for m in self._metrics:
            name = m.name()
            logs[name[0] if isinstance(name, list) else name] = m.accumulate()
        if verbose:
            print("[auto engine] eval " + " ".join(f"{k}={v}" for k, v in logs.items()))
        return logs

    @torch.no_grad()
    def predict(self, test_data=None, test_sample_split=None, batch_size: int = 1,
                steps: Optional[int] = None, collate_fn=None, callbacks=None,
                verbose: int = 0) -> List[np.ndarray]:
        if callbacks is not None:
            raise NotImplementedError("Engine callbacks: use hapi.Model for the callback stack")
        loader = self._loader(test_data, batch_size, shuffle=False, collate_fn=collate_fn)
        self._model.eval()
        outs = []
        for step, batch in enumerate(loader):
            if steps is not None and step >= steps:
                break
            xs = batch[:-1] if isinstance(batch, (list, tuple)) and len(batch) > 1 else batch
            out = self._model(*self._on_device(xs))
            outs.append(out.float().cpu().numpy())
        self._model.train()
        return outs

    # -- persistence --------------------------------------------------------
    def save(self, path: str, training: bool = True) -> None:
        """The model's state dict as a distributed checkpoint at ``path``
        (``checkpoint.save_state_dict``: per-rank shard files and metadata,
        committed atomically, loadable under another layout); with
        ``training``, the optimizer's state dict beside it as
        ``optimizer.pdopt`` (``framework.io``), written after the commit so
        the commit's directory rotation keeps it."""
        from ...framework.io import save as _save
        from ..checkpoint import save_state_dict

        save_state_dict(dict(self._model.state_dict()), path)
        if training and self._optimizer is not None and \
                hasattr(self._optimizer, "state_dict"):
            _save(self._optimizer.state_dict(), os.path.join(path, "optimizer.pdopt"))

    def load(self, path: str, strict: bool = True, load_optimizer: bool = True):
        """Fill the model's parameters and buffers in place from the
        checkpoint at ``path`` (with ``strict`` False, only the keys it
        holds), and the optimizer from ``optimizer.pdopt`` when present."""
        from ...framework.io import load as _load
        from ..checkpoint import load_state_dict
        from ..checkpoint.load_state_dict import read_metadata

        state = dict(self._model.state_dict())
        if not strict:
            saved = set(read_metadata(path).state_dict_metadata)
            state = {k: v for k, v in state.items() if k in saved}
        load_state_dict(state, path)
        opt_path = os.path.join(path, "optimizer.pdopt")
        if load_optimizer and self._optimizer is not None and os.path.exists(opt_path):
            self._optimizer.set_state_dict(_load(opt_path))
        return self


def _tup(x):
    return x if isinstance(x, tuple) else (x,)
