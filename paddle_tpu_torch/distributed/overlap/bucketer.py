"""Bucketed gradient communication (port of the reference's
``distributed/overlap/bucketer.py``; paddle's EagerReducer fused comm
buckets, ``reducer.h:88``): gradients are grouped into buffers of about a
target size, so the first reduction can start while the tail of the
backward pass still computes, instead of one collective a parameter or
one for the whole model.

:class:`GradientBucketer` plans the buckets and coalesces tensors into
them.  Buckets are planned REVERSE-topologically (last parameter first):
the backward pass produces the last layer's gradients first.
``PADDLE_TPU_BUCKET_MB`` (default 25) sets the target payload of a bucket,
0 disables bucketing; a bucket never mixes dtypes, and one tensor larger
than the target gets a bucket of its own.  ``skip`` leaves a tensor out of
every bucket (a tensor-parallel grad, reduced on its own).

:class:`~paddle_tpu_torch.distributed.engine.DistributedTrainStep` uses
the plan: across processes each bucket is one reduce-scatter over the
data x sharding group; on a single-controller mesh, whose gradients are
global tensors already, :meth:`GradientBucketer.constrain` is a value
identity that records the buckets it routed (the reference's sharding
constraint is a value identity too).
"""

from __future__ import annotations

import os
from typing import Any, List, Optional, Sequence, Tuple

import torch

__all__ = ["GradientBucketer", "grad_bucket_bytes", "DEFAULT_BUCKET_MB"]

DEFAULT_BUCKET_MB = 25.0


def grad_bucket_bytes(override: Optional[float] = None) -> int:
    """The bucket target in bytes: an explicit ``override`` (bytes) wins,
    else ``PADDLE_TPU_BUCKET_MB`` (MB, default 25).  <= 0 disables."""
    if override is not None:
        return max(0, int(override))
    try:
        mb = float(os.environ.get("PADDLE_TPU_BUCKET_MB", DEFAULT_BUCKET_MB))
    except ValueError:
        mb = DEFAULT_BUCKET_MB
    return max(0, int(mb * 2 ** 20))


class GradientBucketer:
    """Plan size-targeted comm buckets over an ordered tensor list.

    ``sizes``: each tensor's payload bytes, in model order.  ``keys``: an
    optional coalescing key a tensor (its dtype); tensors of different keys
    never share a bucket.  ``reverse`` (default) plans over the reversed
    list.  ``skip[i]`` leaves tensor i out of every bucket."""

    def __init__(self, sizes: Sequence[int], bucket_bytes: Optional[int] = None,
                 keys: Optional[Sequence[Any]] = None, reverse: bool = True,
                 skip: Optional[Sequence[bool]] = None):
        self.sizes = [int(s) for s in sizes]
        self.bucket_bytes = grad_bucket_bytes(bucket_bytes)
        self.reverse = bool(reverse)
        keys = list(keys) if keys is not None else [None] * len(self.sizes)
        if len(keys) != len(self.sizes):
            raise ValueError("keys and sizes must have equal length")
        self.keys = keys
        skip = list(skip) if skip is not None else [False] * len(self.sizes)
        if len(skip) != len(self.sizes):
            raise ValueError("skip and sizes must have equal length")
        self.skip = [bool(s) for s in skip]
        self.buckets: List[List[int]] = self._plan()
        self.routed = 0      # constrain() calls, each routing every bucket

    def _plan(self) -> List[List[int]]:
        order = [i for i in range(len(self.sizes)) if not self.skip[i]]
        if self.reverse:
            order.reverse()
        buckets: List[List[int]] = []
        cur: List[int] = []
        cur_bytes, cur_key, target = 0, None, self.bucket_bytes
        for i in order:
            sz, key = self.sizes[i], self.keys[i]
            if cur and (cur_key != key or (target > 0 and cur_bytes + sz > target)):
                buckets.append(cur)
                cur, cur_bytes = [], 0
            cur.append(i)
            cur_bytes += sz
            cur_key = key
        if cur:
            buckets.append(cur)
        return buckets

    @property
    def num_buckets(self) -> int:
        return len(self.buckets)

    def bucket_nbytes(self) -> List[int]:
        return [sum(self.sizes[i] for i in b) for b in self.buckets]

    def bucket_of(self, index: int) -> int:
        for bi, b in enumerate(self.buckets):
            if index in b:
                return bi
        raise IndexError(index)

    def _check(self, tensors: Sequence[Any]) -> None:
        if len(tensors) != len(self.sizes):
            raise ValueError(f"bucketer planned over {len(self.sizes)} tensors, "
                             f"got {len(tensors)}")

    def coalesce(self, arrays: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Per bucket, the members flattened and concatenated (firing
        order); :meth:`split` recovers them."""
        self._check(arrays)
        return [torch.cat([arrays[i].reshape(-1) for i in b]) for b in self.buckets]

    def split(self, bucket_arrays: Sequence[torch.Tensor],
              shapes: Sequence[Tuple[int, ...]]) -> List[Optional[torch.Tensor]]:
        """Inverse of :meth:`coalesce`: the original list, in its order and
        shapes (None for a skipped tensor)."""
        out: List[Optional[torch.Tensor]] = [None] * len(self.sizes)
        for b, flat in zip(self.buckets, bucket_arrays):
            off = 0
            for i in b:
                n = 1
                for d in shapes[i]:
                    n *= int(d)
                out[i] = flat[off:off + n].reshape(shapes[i])
                off += n
        return out

    def constrain(self, grads: Sequence[torch.Tensor], mesh,
                  axes=("data", "sharding")) -> List[torch.Tensor]:
        """Route ``grads`` through the buckets over ``axes`` of ``mesh``: a
        value identity (the same tensors, in order) that counts the routing
        in ``routed`` when an axis of ``axes`` is sized above 1 and there
        is a bucket.  On a single-controller mesh a gradient is global
        already, so there is nothing to move."""
        self._check(grads)
        if any(mesh.shape.get(a, 1) > 1 for a in axes) and self.num_buckets:
            self.routed += 1
        return list(grads)
