"""Flash attention over a hybrid mesh (port of the reference's
``ops/sharded.py``, its flash part: ``active_mesh``,
``mesh_flash_supported`` and ``mesh_flash_attention``).

The reference wraps each Pallas kernel in a fully-manual ``shard_map``;
a sequence dim sharded over ``sep`` goes to the ring (``ring_flash``).  The
port runs meshes whose only axis above 1 is ``sep`` (see
``distributed.topology``): the sequence splits into one chunk per ring
member and B10's ring loop (:mod:`.ring_flash`) runs the hops.  The RMSNorm,
rope and Ulysses wrappers over data, sharding and model axes wait for the
NCCL core (ROADMAP A6).
"""

from __future__ import annotations

import math

import torch

from .ring_flash import (RingFlashAttentionFunction, gather_chunks,
                         ring_flash_attention_fwd, split_chunks)

__all__ = ["active_mesh", "mesh_flash_supported", "mesh_flash_attention"]


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
                         causal: bool = False, sep_axis: str = "sep") -> torch.Tensor:
    """Global [b, s, h, d] q/k/v on one device → global out: the ring over
    the mesh's ``sep_axis`` members (B10), or one flash call when the
    degree is 1.  Differentiable: with grad wanted, the forward and backward
    rings run as :class:`RingFlashAttentionFunction`."""
    members = mesh.axis_devices(sep_axis)
    if len(members) == 1:
        from ..nn.functional import scaled_dot_product_attention

        return scaled_dot_product_attention(q, k, v, is_causal=causal, training=False)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return RingFlashAttentionFunction.apply(q, k, v, members, causal)
    out, _ = ring_flash_attention_fwd(*(split_chunks(t, members) for t in (q, k, v)), causal)
    return gather_chunks(out, q.device)
