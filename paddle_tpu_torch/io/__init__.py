"""Data loading (port of the reference's ``io/__init__.py``; paddle's
``python/paddle/io/``): the datasets, the samplers, ``default_collate_fn``
and ``DataLoader``, the parts ``distributed.auto_parallel.Engine`` reads.

The samplers and datasets are the reference's, on numpy.
``DistributedBatchSampler``'s epoch-seeded shuffle
(``np.random.default_rng(epoch)``) gives the same index stream as the
reference's, and shards by process (``torch.distributed``'s rank and world
size once a group exists, else one process).  A sampler given no
``generator`` draws its numpy generator's seed from torch's default CPU
generator, so its order is reproducible after ``torch.manual_seed`` and
differs from epoch to epoch; it is not the JAX package's order, which its
own key stream decides.  ``default_collate_fn`` stacks into host
``torch.Tensor`` batches; a training step moves them to its device.

``DataLoader`` runs in the calling thread (``num_workers=0``) or on a
pool of worker threads (``use_process_workers=False``), both in the
sampler's order.  The reference's worker processes with their
shared-memory transport wait for ROADMAP A10 and raise.
"""

from __future__ import annotations

import bisect
import itertools
import queue
import threading
from typing import Any, Iterator, List, Optional, Sequence

import numpy as np
import torch

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset", "ChainDataset",
           "ConcatDataset", "Subset", "random_split", "Sampler", "SequenceSampler",
           "RandomSampler", "WeightedRandomSampler", "BatchSampler",
           "DistributedBatchSampler", "DataLoader", "get_worker_info", "default_collate_fn"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset is not subscriptable")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    def __init__(self, tensors: Sequence):
        self.tensors = [torch.as_tensor(t) for t in tensors]
        n = self.tensors[0].shape[0]
        if any(t.shape[0] != n for t in self.tensors):
            raise ValueError("all tensors must have the same first dimension")

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets: List[Dataset]):
        self.datasets = datasets

    def __getitem__(self, idx):
        out = []
        for ds in self.datasets:
            item = ds[idx]
            out.extend(item if isinstance(item, (list, tuple)) else [item])
        return tuple(out)

    def __len__(self):
        return min(len(ds) for ds in self.datasets)


class ChainDataset(IterableDataset):
    def __init__(self, datasets: List[IterableDataset]):
        self.datasets = datasets

    def __iter__(self):
        for ds in self.datasets:
            yield from ds


class ConcatDataset(Dataset):
    def __init__(self, datasets: List[Dataset]):
        self.datasets = list(datasets)
        self.cumulative_sizes = list(itertools.accumulate(len(d) for d in self.datasets))

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        prev = 0 if ds_idx == 0 else self.cumulative_sizes[ds_idx - 1]
        return self.datasets[ds_idx][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset: Dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset: Dataset, lengths: Sequence, generator=None) -> List[Subset]:
    if all(isinstance(length, float) for length in lengths):
        n = len(dataset)
        counts = [int(np.floor(n * length)) for length in lengths]
        counts[0] += n - sum(counts)
        lengths = counts
    total = sum(lengths)
    if total != len(dataset):
        raise ValueError(f"sum of lengths {total} != dataset size {len(dataset)}")
    perm = _np_rng(generator).permutation(total).tolist()
    out, offset = [], 0
    for length in lengths:
        out.append(Subset(dataset, perm[offset:offset + length]))
        offset += length
    return out


def _np_rng(generator=None) -> np.random.Generator:
    """The numpy generator of a draw: ``generator`` itself (a numpy
    Generator), seeded by it (an int or a ``torch.Generator``), or seeded
    from torch's default CPU generator (reproducible after
    ``torch.manual_seed``, advancing a draw)."""
    if isinstance(generator, np.random.Generator):
        return generator
    if generator is None or isinstance(generator, torch.Generator):
        entropy = torch.randint(0, 2 ** 31 - 1, (4,), generator=generator).tolist()
        return np.random.default_rng(entropy)
    return np.random.default_rng(generator)


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))

    def __len__(self):
        return len(self.data_source)


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement: bool = False, num_samples: Optional[int] = None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        rng = _np_rng(self.generator)
        if self.replacement:
            return iter(rng.integers(0, n, self.num_samples).tolist())
        return iter(rng.permutation(n)[: self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples: int, replacement: bool = True):
        super().__init__(None)
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = _np_rng().choice(len(self.weights), self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    """Index batcher with a resumable position: ``state_dict()`` /
    ``set_state_dict()`` carry ``(epoch, position)``, position being the
    batches already yielded this epoch, and ``fast_forward(n)`` skips the
    next ``n`` batches (the reference's rewind protocol)."""

    def __init__(self, dataset=None, sampler=None, shuffle: bool = False, batch_size: int = 1,
                 drop_last: bool = False):
        super().__init__(dataset)
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.epoch = 0
        self._position = 0
        self._resume_from = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def state_dict(self) -> dict:
        return {"epoch": int(self.epoch), "position": int(self._position)}

    def set_state_dict(self, state: dict) -> None:
        self.set_epoch(state.get("epoch", 0))
        self._resume_from = int(state.get("position", 0))
        self._position = self._resume_from

    def fast_forward(self, n_batches: int) -> None:
        self._resume_from = self._position + int(n_batches)
        self._position = self._resume_from

    def _positioned(self, gen):
        """Skip up to the resume point, then count the batches yielded."""
        start, self._resume_from = self._resume_from, 0
        n = 0
        for batch in gen:
            n += 1
            if n <= start:
                continue
            self._position = n
            yield batch
        self._position = 0

    def _gen_batches(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __iter__(self):
        return self._positioned(self._gen_batches())

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """A process's share of the batches (reference
    ``io/dataloader/batch_sampler.py``): the indices padded to a multiple
    of ``num_replicas``, every ``num_replicas``-th from ``rank``, shuffled
    by ``np.random.default_rng(epoch)`` when ``shuffle`` (``set_epoch``)."""

    def __init__(self, dataset, batch_size: int, num_replicas: Optional[int] = None,
                 rank: Optional[int] = None, shuffle: bool = False, drop_last: bool = False):
        import torch.distributed as dist

        self.dataset = dataset
        self.batch_size = batch_size
        grouped = dist.is_available() and dist.is_initialized()
        if num_replicas is None:
            num_replicas = dist.get_world_size() if grouped else 1
        if rank is None:
            rank = dist.get_rank() if grouped else 0
        self.nranks = num_replicas
        self.local_rank = rank
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self._position = 0
        self._resume_from = 0
        self.num_samples = int(np.ceil(len(dataset) / num_replicas))
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _gen_batches(self):
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            indices = np.random.default_rng(self.epoch).permutation(n)
        indices = np.concatenate([indices, indices[: self.total_size - n]])
        indices = indices[self.local_rank: self.total_size: self.nranks].tolist()
        batch = []
        for idx in indices:
            batch.append(int(idx))
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __iter__(self):
        return self._positioned(self._gen_batches())

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size


class _WorkerInfo:
    def __init__(self, id, num_workers, dataset):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset


_worker_info = threading.local()


def get_worker_info():
    return getattr(_worker_info, "info", None)


def default_collate_fn(batch: List[Any]):
    """Samples stacked into a batch, structure kept: tensors and arrays
    into one host tensor, numbers into a 1-D tensor, lists, tuples and
    dicts field by field."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return torch.stack([b.detach().cpu() for b in batch])
    if isinstance(sample, np.ndarray):
        return torch.from_numpy(np.stack(batch))
    if isinstance(sample, (int, float, np.number)):
        return torch.as_tensor(np.asarray(batch))
    if isinstance(sample, (list, tuple)):
        return type(sample)(default_collate_fn(list(items)) for items in zip(*batch))
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    return batch


class DataLoader:
    """Batches of ``dataset`` in the batch sampler's order (reference
    ``io/dataloader/dataloader_iter.py``): collated in the calling thread
    at ``num_workers=0``, else by ``num_workers`` threads with
    ``use_process_workers=False`` (each thread takes every
    ``num_workers``-th batch; an ordered buffer hands them over in order).
    The position in the epoch (``state_dict``) counts the batches
    delivered.  Worker processes (``use_process_workers``, the reference's
    default) wait for ROADMAP A10 and raise."""

    def __init__(self, dataset, feed_list=None, places=None, return_list: bool = True,
                 batch_sampler=None, batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = False, collate_fn=None, num_workers: int = 0,
                 use_buffer_reader: bool = True, prefetch_factor: int = 2,
                 use_shared_memory: bool = True, timeout: int = 0, worker_init_fn=None,
                 persistent_workers: bool = False, use_process_workers: bool = True):
        self.dataset = dataset
        self.num_workers = num_workers
        self.collate_fn = collate_fn or default_collate_fn
        self.prefetch_factor = prefetch_factor
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self.use_process_workers = use_process_workers
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                              batch_size=batch_size, drop_last=drop_last)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset DataLoader has no len()")
        return len(self.batch_sampler)

    def state_dict(self) -> dict:
        bs = self.batch_sampler
        if bs is None or not hasattr(bs, "state_dict"):
            return {}
        return bs.state_dict()

    def set_state_dict(self, state: dict) -> None:
        bs = self.batch_sampler
        if state and bs is not None and hasattr(bs, "set_state_dict"):
            bs.set_state_dict(state)

    def __iter__(self) -> Iterator:
        if self._iterable_mode:
            return self._iter_iterable()
        if self.num_workers == 0:
            return self._iter_sync()
        if self.use_process_workers:
            raise NotImplementedError(
                "DataLoader worker processes (num_workers > 0 with use_process_workers) "
                "are not ported yet (ROADMAP A10); pass use_process_workers=False for "
                "worker threads, or num_workers=0")
        start = getattr(self.batch_sampler, "_resume_from", 0)
        return self._track_position(self._iter_threaded(), start)

    def _track_position(self, gen, start: int):
        """The batches delivered, mirrored into the batch sampler's position
        (its own count ran out when the epoch's indices were listed)."""
        bs = self.batch_sampler
        n = start
        for item in gen:
            n += 1
            bs._position = n
            yield item
        bs._position = 0

    def _iter_sync(self):
        for batch_idx in self.batch_sampler:
            yield self.collate_fn([self.dataset[i] for i in batch_idx])

    def _iter_iterable(self):
        batch = []
        for item in self.dataset:
            batch.append(item)
            if len(batch) == self.batch_size:
                yield self.collate_fn(batch)
                batch = []
        if batch and not self.drop_last:
            yield self.collate_fn(batch)

    def _iter_threaded(self):
        indices = list(self.batch_sampler)
        results: "queue.Queue" = queue.Queue(maxsize=self.num_workers * self.prefetch_factor)

        def worker(worker_id, my_batches):
            _worker_info.info = _WorkerInfo(worker_id, self.num_workers, self.dataset)
            if self.worker_init_fn is not None:
                self.worker_init_fn(worker_id)
            for seq, batch_idx in my_batches:
                try:
                    data = self.collate_fn([self.dataset[i] for i in batch_idx])
                except BaseException as e:  # handed to the consumer, who raises it
                    results.put((seq, e))
                    return
                results.put((seq, data))

        threads = []
        for w in range(self.num_workers):
            mine = [(i, b) for i, b in enumerate(indices) if i % self.num_workers == w]
            t = threading.Thread(target=worker, args=(w, mine), daemon=True)
            t.start()
            threads.append(t)
        buffered = {}
        next_seq, total = 0, len(indices)
        while next_seq < total:
            while next_seq in buffered:
                data = buffered.pop(next_seq)
                if isinstance(data, BaseException):
                    raise data
                yield data
                next_seq += 1
            if next_seq >= total:
                break
            try:
                seq, data = results.get(timeout=self.timeout or None)
            except queue.Empty:
                raise RuntimeError(f"DataLoader worker timed out after {self.timeout}s "
                                   f"(batch {next_seq})") from None
            buffered[seq] = data
        for t in threads:
            t.join(timeout=1.0)
