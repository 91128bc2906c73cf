"""Context (long-sequence) parallelism over the ``sep`` mesh axis: ring
attention and Ulysses (port of the reference's
``distributed/meta_parallel/context_parallel.py``).

Both take the GLOBAL [b, s, h, d] tensors (paddle flash-attn layout) on one
device and return the global output there; the mesh's ``sep`` members (see
``distributed.topology``; one process drives them all) do the work.

- :func:`ring_attention`: the sequence splits into one chunk per member and
  the K/V chunks rotate around the ring with the online-softmax merge, B10
  (``ops/ring_flash.py``): the flash kernels B3/B3b/B3c per hop and the
  merge kernel on the card, the same schedule over the plain twins on the
  CPU or with ``use_flash_attention`` off.  The reference's plain path is a
  jnp online-softmax scan that computes the same function; the port keeps
  one ring loop.  Differentiable.
- :func:`ulysses_attention`: the heads split over the ``model`` × ``sep``
  members (``ops.sharded.mesh_ulysses_flash``), each runs flash attention
  (B3; B3b/B3c with grad) over the full sequence for its heads, and the
  outputs concatenate.

The reference's ``scale`` argument is taken only as ``None`` or
1/sqrt(head_dim), the one scale of the port's flash kernels.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...ops.attention import sdpa_reference
from ...ops.sharded import check_flash_scale, mesh_flash_attention, mesh_ulysses_flash
from ..topology import get_hybrid_communicate_group

__all__ = ["ring_attention", "ulysses_attention"]


def _resolve_mesh(mesh):
    if mesh is not None:
        return mesh
    hcg = get_hybrid_communicate_group()
    if hcg is None:
        raise RuntimeError("context parallelism needs a mesh: pass mesh= or set a "
                           "hybrid communicate group first")
    return hcg.mesh


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh=None,
                      sep_axis: str = "sep", is_causal: bool = False,
                      scale: Optional[float] = None) -> torch.Tensor:
    """[b, s, h, d] attention with the heads split over the ``model`` ×
    ``sep_axis`` members (DeepSpeed-Ulysses' head-sharded phase, batch over
    data × sharding): each member attends over the full sequence with its q
    heads and their kv heads, then the outputs concatenate along the heads
    on q's device."""
    mesh = _resolve_mesh(mesh)
    n = mesh.shape[sep_axis]
    if q.shape[2] % n or k.shape[2] % n:
        raise ValueError(
            f"Ulysses needs q heads ({q.shape[2]}) AND kv heads ({k.shape[2]}) "
            f"divisible by the sep degree ({n}) — the head-sharded phase splits both")
    return mesh_ulysses_flash(q, k, v, mesh, causal=is_causal, scale=scale,
                              sep_axis=sep_axis)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh=None,
                   sep_axis: str = "sep", causal: bool = False,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Blockwise ring attention over the ``sep_axis`` ring (module
    docstring).  q [b, s, hq, d], k/v [b, s, hkv, d] with kv heads dividing
    q heads and s divisible by the sep degree; a degree of 1 is plain
    attention (``sdpa_reference``), as in the reference."""
    mesh = _resolve_mesh(mesh)
    n = mesh.shape[sep_axis]
    b, s, h, d = q.shape
    hkv = k.shape[2]
    if h % hkv != 0:
        raise ValueError(f"ring_attention GQA requires kv heads ({hkv}) to "
                         f"divide q heads ({h})")
    if s % n != 0:
        raise ValueError(f"sequence {s} not divisible by sep degree {n}")
    check_flash_scale(scale, d)
    if n == 1:
        return sdpa_reference(q, k, v, is_causal=causal)
    return mesh_flash_attention(q, k, v, mesh, causal=causal, sep_axis=sep_axis)
