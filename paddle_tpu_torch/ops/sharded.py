"""The kernels over a hybrid mesh (port of the reference's ``ops/sharded.py``:
``active_mesh`` and the flash, Ulysses, RMSNorm and rope wrappers).

The reference wraps each Pallas kernel in a fully-manual ``shard_map``: a
global array goes in, each device runs the kernel on its block, and the
blocks make the global result.  The port's meshes are driven from one
process (``distributed.topology``: a member is a position on the mesh and
members may share a card), so a wrapper here takes GLOBAL tensors on one
device, gives each member its block on the member's device, runs the
already-ported kernel there (or its autograd Function when a gradient is
wanted, or the plain twin for a CPU tensor) and joins the blocks on the
caller's device.  The layouts are the reference's:

- batch dims over ``data`` × ``sharding``;
- heads over ``model``;
- a sequence dim over ``sep``: the flash wrapper runs B10's ring over the
  ``sep`` members (:mod:`.ring_flash`), the RMSNorm and rope wrappers
  split the rows (rope's position-table rows ride along);
- Ulysses: the full sequence per member, heads over ``model`` × ``sep``;
- an axis a layout does not name (``pipe``; ``model`` for RMSNorm) sees
  replicated data, which the single controller computes once, on the
  member at position 0 of that axis.

Blocks are independent rows and heads, so a wrapper's forward is
bit-equal to one kernel call on the whole tensor.

The gates keep the reference's divisibility rules (``_attn_local_shapes``,
rows % 8 and hidden % 128 for RMSNorm, 8-aligned sequences for rope).  Its
TPU tile rules do not carry over: ``_auto_block`` and the
``flash_block_q/k`` flags fit Pallas block shapes, and the H100 kernels
take any sequence length, so the flash gates check the kernels' own
head_dim rule instead (ROADMAP §C).

Only a single-controller mesh routes here: a process of a multi-process
mesh (``Mesh.procs``) holds only its own rows, so :func:`active_mesh` is
None there and its kernels run on those rows directly.
"""

from __future__ import annotations

import itertools
import math
from typing import Optional, Tuple

import torch

from ..framework.flags import get_flags
from .ring_flash import (RingFlashAttentionFunction, gather_chunks,
                         ring_flash_attention_fwd, split_chunks)

__all__ = ["active_mesh", "mesh_route", "mesh_flash_supported", "mesh_flash_attention",
           "mesh_ulysses_flash_supported", "mesh_ulysses_flash",
           "mesh_rms_norm_supported", "mesh_rms_norm",
           "mesh_rope_supported", "mesh_rope", "check_flash_scale"]


def check_flash_scale(scale: Optional[float], d: int) -> None:
    """Raise unless ``scale`` is None or 1/sqrt(d), the one scale of the
    port's flash kernels."""
    if scale is not None and not math.isclose(scale, 1.0 / math.sqrt(d), rel_tol=1e-6):
        raise NotImplementedError(
            f"scale {scale} is not ported; the port's flash kernels scale by "
            f"1/sqrt(head_dim) = {1.0 / math.sqrt(d)}")


def active_mesh():
    """The hybrid mesh when one is live, has more than one member and is
    driven from this one process, else None."""
    from ..distributed.topology import get_hybrid_communicate_group

    hcg = get_hybrid_communicate_group()
    if hcg is None or hcg.mesh.procs is not None or \
            math.prod(hcg.mesh.shape.values()) <= 1:
        return None
    return hcg.mesh


def mesh_route(flag_name: str):
    """The mesh the functional ops route ``flag_name``'s kernel through:
    :func:`active_mesh` when the flag is on, else None (the counterpart of
    the reference's ``pallas_mode`` returning ``"mesh"``)."""
    mesh = active_mesh()
    return mesh if mesh is not None and get_flags(flag_name)[flag_name] else None


def _size(mesh, name: str) -> int:
    return mesh.shape.get(name, 1)


def _batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("data", "sharding") if _size(mesh, a) > 1)


def _member(mesh, coords) -> torch.device:
    return mesh.devices[tuple(coords.get(a, 0) for a in mesh.axis_names)]


def _blocked(mesh, tensors, layout, fn, coords=None):
    """Split ``tensors`` by ``layout`` — a list of ``(axes, in_dims,
    out_dims)``, outermost first: ``in_dims[i]`` is the dim of
    ``tensors[i]`` split over ``axes`` (None: every block gets it whole),
    ``out_dims[j]`` the dim the blocks of output j join along — call
    ``fn(coords, *blocks)`` for each member's blocks (``coords``: the
    member's position on the split axes; it returns a tuple) and join."""
    coords = coords or {}
    if not layout:
        return fn(coords, *tensors)
    (axes, in_dims, out_dims), rest = layout[0], layout[1:]
    n = math.prod(_size(mesh, a) for a in axes)
    if n == 1:
        return _blocked(mesh, tensors, rest, fn, coords)
    outs = []
    for i, pos in enumerate(itertools.product(*(range(_size(mesh, a)) for a in axes))):
        parts = []
        for t, dim in zip(tensors, in_dims):
            if dim is not None:
                if t.shape[dim] % n:
                    raise ValueError(f"dim {dim} of shape {tuple(t.shape)} does not "
                                     f"divide over {axes} ({n} members)")
                w = t.shape[dim] // n
                t = t.narrow(dim, i * w, w)
            parts.append(t)
        outs.append(_blocked(mesh, parts, rest, fn, {**coords, **dict(zip(axes, pos))}))
    return tuple(torch.cat([o[j] for o in outs], dim) for j, dim in enumerate(out_dims))


def _on(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A block as a kernel takes it: contiguous, on its member's device."""
    return t.contiguous().to(dev)


def _head_dim_ok(d: int) -> bool:
    """The flash kernels' head_dim rule (the port's local gate)."""
    return d % 8 == 0 and d <= 256


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------
def _attn_local_shapes(mesh, q_shape, k_shape, sep_axis: str = "sep"):
    b, sq, hq, d = q_shape
    _, sk, hkv, _ = k_shape
    dp = math.prod(_size(mesh, a) for a in _batch_axes(mesh)) or 1
    mp = max(_size(mesh, "model"), 1)
    sep = max(_size(mesh, sep_axis), 1)
    if b % dp or sq % sep or sk % sep or hq % mp or hkv % mp:
        return None
    return ((b // dp, sq // sep, hq // mp, d),
            (b // dp, sk // sep, hkv // mp, d), sep)


def mesh_flash_supported(mesh, q_shape, k_shape, *, has_mask: bool, dropout_p: float,
                         causal: bool, sep_axis: str = "sep") -> bool:
    """Whether :func:`mesh_flash_attention` takes these shapes: no mask or
    dropout; batch divisible by data × sharding, q and kv heads by model,
    the sequence by the sep degree with q and kv chunked alike; kv heads
    dividing q heads, the flash kernels' head_dim, and sq <= sk when
    causal."""
    local = _attn_local_shapes(mesh, q_shape, k_shape, sep_axis)
    if local is None or has_mask or dropout_p != 0.0:
        return False
    lq, lk, sep = local
    if sep > 1 and lq[1] != lk[1]:
        return False     # the ring needs q and kv chunked alike
    return (_head_dim_ok(lq[3]) and lq[2] % lk[2] == 0
            and (not causal or lq[1] <= lk[1]))


def _ring(q, k, v, members, causal: bool) -> torch.Tensor:
    """B10 over ``members`` on global [b, s, h, d] blocks: differentiable
    when grad is wanted."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return RingFlashAttentionFunction.apply(q, k, v, members, causal)
    out, _ = ring_flash_attention_fwd(*(split_chunks(t, members) for t in (q, k, v)), causal)
    return gather_chunks(out, q.device)


def mesh_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh, *,
                         causal: bool = False, scale: Optional[float] = None,
                         interpret: bool = False, sep_axis: str = "sep") -> torch.Tensor:
    """Global [b, s, h, d] q/k/v on one device → global out: batch blocks
    over data × sharding, head blocks over model; each member runs flash
    attention (B3, or B3b/B3c through its autograd Function when a
    gradient is wanted) on its block, or, with a ``sep_axis`` degree above
    1, the ring (B10) over that block's sep members.  ``scale`` is taken
    as None or 1/sqrt(head_dim), the kernels' one scale;
    ``interpret`` (the Pallas interpreter) has no counterpart: CPU tensors
    run the plain twins."""
    from ..nn.functional import _attention

    check_flash_scale(scale, q.shape[3])
    if _attn_local_shapes(mesh, q.shape, k.shape, sep_axis) is None:
        raise ValueError(
            f"mesh flash attention needs batch divisible by the data degree, "
            f"q/kv heads by the model degree and the sequence by the "
            f"{sep_axis} degree; got q{tuple(q.shape)} k{tuple(k.shape)} on mesh "
            f"{dict(mesh.shape)}")
    sep = _size(mesh, sep_axis)

    def member(coords, qb, kb, vb):
        if sep > 1:
            ring = [_member(mesh, {**coords, sep_axis: i}) for i in range(sep)]
            return (_ring(qb, kb, vb, ring, causal),)
        dev = _member(mesh, coords)
        return (_attention(_on(qb, dev), _on(kb, dev), _on(vb, dev), causal).to(q.device),)

    layout = [(_batch_axes(mesh), (0, 0, 0), (0,)), (("model",), (2, 2, 2), (2,))]
    return _blocked(mesh, (q, k, v), layout, member)[0]


# ---------------------------------------------------------------------------
# Ulysses flash attention (the head-sharded phase)
# ---------------------------------------------------------------------------
def _ulysses_heads(mesh, sep_axis: str) -> Tuple[str, ...]:
    return tuple(a for a in ("model", sep_axis) if _size(mesh, a) > 1)


def _ulysses_local_shapes(mesh, q_shape, k_shape, sep_axis):
    b, sq, hq, d = q_shape
    _, sk, hkv, _ = k_shape
    dp = math.prod(_size(mesh, a) for a in _batch_axes(mesh)) or 1
    hdeg = math.prod(_size(mesh, a) for a in _ulysses_heads(mesh, sep_axis)) or 1
    if b % dp or hq % hdeg or hkv % hdeg:
        return None
    return ((b // dp, sq, hq // hdeg, d), (b // dp, sk, hkv // hdeg, d))


def mesh_ulysses_flash_supported(mesh, q_shape, k_shape, *, has_mask: bool,
                                 dropout_p: float, causal: bool,
                                 sep_axis: str = "sep") -> bool:
    """Whether :func:`mesh_ulysses_flash` takes these shapes: batch
    divisible by data × sharding, q and kv heads by model × sep, and the
    flash kernels' own rules on a member's block."""
    local = _ulysses_local_shapes(mesh, q_shape, k_shape, sep_axis)
    if local is None or has_mask or dropout_p != 0.0:
        return False
    lq, lk = local
    return (_head_dim_ok(lq[3]) and lq[2] % lk[2] == 0
            and (not causal or lq[1] <= lk[1]))


def mesh_ulysses_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh, *,
                       causal: bool = False, scale: Optional[float] = None,
                       interpret: bool = False, sep_axis: str = "sep") -> torch.Tensor:
    """Global [b, s, h, d] → global out, the Ulysses attention phase: every
    member attends over the FULL sequence with its head block (heads over
    model × ``sep_axis``, model major, as the reference's spec lays them
    out) and its batch block (over data × sharding), by flash attention
    (B3; B3b/B3c with grad).  The reference's head↔sequence all-to-alls are
    the split and the join here."""
    from ..nn.functional import _attention

    check_flash_scale(scale, q.shape[3])
    if _ulysses_local_shapes(mesh, q.shape, k.shape, sep_axis) is None:
        raise ValueError(
            f"Ulysses flash needs batch divisible by the data degree and "
            f"q/kv heads divisible by model*{sep_axis}; got q{tuple(q.shape)} "
            f"k{tuple(k.shape)} on mesh {dict(mesh.shape)} — check "
            f"mesh_ulysses_flash_supported first")

    def member(coords, qb, kb, vb):
        dev = _member(mesh, coords)
        return (_attention(_on(qb, dev), _on(kb, dev), _on(vb, dev), causal).to(q.device),)

    layout = [(_batch_axes(mesh), (0, 0, 0), (0,)),
              (_ulysses_heads(mesh, sep_axis), (2, 2, 2), (2,))]
    return _blocked(mesh, (q, k, v), layout, member)[0]


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------
def _rows_layout(mesh, ndim: int):
    """[batch, (seq,) ..., hidden]: dim 0 over data × sharding, dim 1 over
    sep when the rank is at least 3; hidden whole (the norm reduces over
    it)."""
    layout = [(_batch_axes(mesh), (0, None), (0,))]
    if ndim >= 3:
        layout.append((("sep",), (1, None), (1,)))
    return layout


def mesh_rms_norm_supported(mesh, x_shape) -> bool:
    """Rows divisible over the batch axes (and sep for rank >= 3), a
    member's rows a multiple of 8 and hidden a multiple of 128 (the
    reference's gate, kept)."""
    dp = math.prod(_size(mesh, a) for a in _batch_axes(mesh)) or 1
    sep = max(_size(mesh, "sep"), 1)
    if x_shape[0] % dp:
        return False
    if len(x_shape) >= 3 and x_shape[1] % sep:
        return False
    rows = math.prod(x_shape[:-1]) // (dp * (sep if len(x_shape) >= 3 else 1))
    return rows % 8 == 0 and x_shape[-1] % 128 == 0


def mesh_rms_norm(x: torch.Tensor, weight: torch.Tensor, mesh, eps: float,
                  interpret: bool = False) -> torch.Tensor:
    """RMSNorm of global ``x`` with the replicated ``weight``: each member
    normalises its rows (batch over data × sharding, the sequence over
    sep) by B1, or through its autograd Function (B1 and B1b) when a
    gradient is wanted; the weight's gradient is then the sum of the
    members' partial dw."""
    from ..nn.functional import _rms_norm

    def member(coords, xb, w):
        dev = _member(mesh, coords)
        return (_rms_norm(_on(xb, dev), w.to(dev), eps).to(x.device),)

    return _blocked(mesh, (x, weight), _rows_layout(mesh, x.dim()), member)[0]


# ---------------------------------------------------------------------------
# rope
# ---------------------------------------------------------------------------
def mesh_rope_supported(mesh, q_shape, k_shape) -> bool:
    """The flash layout's divisibility, 8-aligned sequence blocks and an
    even head_dim (the reference's gate)."""
    local = _attn_local_shapes(mesh, q_shape, k_shape)
    if local is None:
        return False
    lq, lk, _ = local
    return lq[1] % 8 == 0 and lk[1] % 8 == 0 and lq[3] % 2 == 0


def mesh_rope(q: torch.Tensor, k: torch.Tensor, cos_s: torch.Tensor, sin_s: torch.Tensor,
              mesh, interpret: bool = False):
    """q/k [b, s, h, d] global, ``cos_s``/``sin_s`` [s, d] the position
    tables of the sequence's rows: the table rows ride the same sep split
    as the sequence, so each member rotates its block (batch over data ×
    sharding, heads over model) at its own positions, by B2 (B2 bwd
    through its autograd Function with grad).  Returns (q, k)."""
    from .rope import rotate

    def member(coords, qb, kb, cb, sb):
        dev = _member(mesh, coords)
        b, s = qb.shape[:2]
        pos = torch.arange(s, device=dev, dtype=torch.int32).expand(b, s).contiguous()
        rq, rk = rotate(_on(qb, dev), _on(kb, dev), _on(cb.float(), dev),
                        _on(sb.float(), dev), pos)
        return rq.to(q.device), rk.to(k.device)

    layout = [(_batch_axes(mesh), (0, 0, None, None), (0, 0)),
              (("sep",), (1, 1, 0, 0), (1, 1)),
              (("model",), (2, 2, None, None), (2, 2))]
    return _blocked(mesh, (q, k, cos_s, sin_s), layout, member)
