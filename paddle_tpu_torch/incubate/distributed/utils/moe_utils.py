"""MoE dispatch utilities (port of the reference's
``incubate/distributed/utils/moe_utils.py``: ``count_by_gate``,
``global_scatter``, ``global_gather``).

They keep the reference's count-based transport API for host-side custom
routing; the MoE layers route by index (``incubate.distributed.models.
moe``).  The placement follows the counts, so ``global_scatter`` and
``global_gather`` read the counts to the host: one device-to-host read a
call, as the reference needs concrete counts.  Tokens go into a
fixed-capacity ``[expert, capacity, d]`` buffer with the layers' drop and
pad semantics.  Both are differentiable in ``x``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["count_by_gate", "global_scatter", "global_gather"]


def count_by_gate(gate_idx, num_expert: int, world_size: int = 1,
                  require_pos: bool = True, group=None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-expert routing statistics: ``(pos, local_expert_count,
    global_expert_count)``.  ``pos``: the tokens in expert order (a stable
    argsort of the gate indices), int32; the counts: int32
    ``[num_expert * world_size]`` tokens routed to each global expert, the
    same for both (one controller sees every token).  Raises
    ``ValueError`` on an index outside the experts (a host read)."""
    idx = torch.as_tensor(gate_idx).reshape(-1).long()
    e = num_expert * world_size
    if idx.numel():
        lo, hi = (int(v) for v in torch.stack([idx.min(), idx.max()]).cpu())
        if hi >= e or lo < 0:
            raise ValueError(f"gate index out of range [0, {e}): min={lo}, max={hi}")
    counts = torch.bincount(idx, minlength=e).to(torch.int32)
    pos = (torch.sort(idx, stable=True).indices.to(torch.int32) if require_pos
           else torch.zeros((0,), dtype=torch.int32, device=idx.device))
    return pos, counts, counts


def _placement(local_count, n: int):
    """The expert and slot of each of the first ``n`` expert-sorted rows,
    from the counts (read to the host)."""
    counts = torch.as_tensor(local_count).cpu().numpy().astype(np.int64)
    expert_of = np.repeat(np.arange(counts.shape[0]), counts)[:n]
    slot_of = (np.concatenate([np.arange(c) for c in counts])[:n] if counts.size
               else np.zeros((0,), np.int64))
    return counts, expert_of, slot_of


def global_scatter(x, local_count, global_count, group=None,
                   use_calc_stream: bool = True,
                   capacity: Optional[int] = None) -> torch.Tensor:
    """Expert-sorted rows ``x`` [n, d] (as ``pos`` orders them) into
    ``[E, capacity, d]``: expert ``e``'s buffer holds its rows in arrival
    order, zero-padded; rows past the capacity drop.  ``capacity``
    defaults to the largest count (at least 1)."""
    x = torch.as_tensor(x)
    n, d = x.shape
    counts, expert_of, slot_of = _placement(local_count, n)
    e = int(counts.shape[0])
    cap = int(capacity) if capacity is not None else \
        max(1, int(counts.max())) if counts.size else 1
    keep = slot_of < cap
    dev = x.device
    rows = torch.as_tensor(np.nonzero(keep)[0], device=dev)
    at = (torch.as_tensor(expert_of[keep], device=dev),
          torch.as_tensor(slot_of[keep], device=dev))
    return x.new_zeros(e, cap, d).index_put(at, x.index_select(0, rows))


def global_gather(x, local_count, global_count, group=None,
                  use_calc_stream: bool = True) -> torch.Tensor:
    """The inverse of :func:`global_scatter`: ``[E, capacity, d]`` back to
    the expert-sorted rows the counts describe; dropped rows come back
    zero."""
    x = torch.as_tensor(x)
    _, cap, d = x.shape
    counts, expert_of, slot_of = _placement(local_count, None)
    n = int(counts.sum())
    keep = slot_of < cap
    dev = x.device
    rows = torch.as_tensor(np.nonzero(keep)[0], device=dev)
    picked = x[torch.as_tensor(expert_of[keep], device=dev),
               torch.as_tensor(slot_of[keep], device=dev)]
    return x.new_zeros(n, d).index_copy(0, rows, picked)
