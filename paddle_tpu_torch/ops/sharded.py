"""Flash attention over a hybrid mesh (port of the reference's
``ops/sharded.py``, its flash part: ``active_mesh``,
``mesh_flash_supported`` and ``mesh_flash_attention``).

The reference wraps each Pallas kernel in a fully-manual ``shard_map``;
a sequence dim sharded over ``sep`` goes to the ring (``ring_flash``).  The
port runs meshes whose only axis above 1 is ``sep`` (see
``distributed.topology``): the sequence splits into one chunk per ring
member and B10's ring loop (:mod:`.ring_flash`) runs the hops.  The RMSNorm,
rope and Ulysses wrappers over the data, sharding and model axes wait for
the mesh axes (ROADMAP A6b).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .ring_flash import (RingFlashAttentionFunction, gather_chunks,
                         ring_flash_attention_fwd, split_chunks)

__all__ = ["active_mesh", "mesh_flash_supported", "mesh_flash_attention",
           "check_flash_scale"]


def check_flash_scale(scale: Optional[float], d: int) -> None:
    """Raise unless ``scale`` is None or 1/sqrt(d), the one scale of the
    port's flash kernels."""
    if scale is not None and not math.isclose(scale, 1.0 / math.sqrt(d), rel_tol=1e-6):
        raise NotImplementedError(
            f"scale {scale} is not ported; the port's flash kernels scale by "
            f"1/sqrt(head_dim) = {1.0 / math.sqrt(d)}")


def active_mesh():
    """The hybrid mesh when one is live and has more than one member,
    else None."""
    from ..distributed.topology import get_hybrid_communicate_group

    hcg = get_hybrid_communicate_group()
    if hcg is None or math.prod(hcg.mesh.shape.values()) <= 1:
        return None
    return hcg.mesh


def mesh_flash_supported(mesh, q_shape, k_shape, *, has_mask: bool, dropout_p: float,
                         causal: bool, sep_axis: str = "sep") -> bool:
    """Whether :func:`mesh_flash_attention` takes these shapes: no mask or
    dropout, the sequence divisible by the sep degree with q and kv chunked
    alike, and the flash kernels' head_dim (a multiple of 8, at most 256)
    with kv heads dividing q heads."""
    b, sq, hq, d = q_shape
    _, sk, hkv, _ = k_shape
    sep = mesh.shape.get(sep_axis, 1)
    return (not has_mask and dropout_p == 0.0 and sq % sep == 0 and sk % sep == 0
            and (sep == 1 or sq == sk) and d % 8 == 0 and d <= 256 and hq % hkv == 0
            and (not causal or sq <= sk))


def mesh_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh, *,
                         causal: bool = False, scale: Optional[float] = None,
                         interpret: bool = False, sep_axis: str = "sep") -> torch.Tensor:
    """Global [b, s, h, d] q/k/v on one device → global out: the ring over
    the mesh's ``sep_axis`` members (B10), or one flash call when the
    degree is 1.  Differentiable: with grad wanted, the forward and backward
    rings run as :class:`RingFlashAttentionFunction`.  ``scale`` is taken
    as None or 1/sqrt(head_dim), the flash kernels' one scale (the ring's
    departure, ``context_parallel``); ``interpret`` (the Pallas
    interpreter) has no counterpart: CPU tensors run the plain twins."""
    check_flash_scale(scale, q.shape[3])
    members = mesh.axis_devices(sep_axis)
    if len(members) == 1:
        from ..nn.functional import scaled_dot_product_attention

        return scaled_dot_product_attention(q, k, v, is_causal=causal, training=False)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return RingFlashAttentionFunction.apply(q, k, v, members, causal)
    out, _ = ring_flash_attention_fwd(*(split_chunks(t, members) for t in (q, k, v)), causal)
    return gather_chunks(out, q.device)
