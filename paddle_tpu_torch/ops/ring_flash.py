"""B10, ring flash attention: the ring loop over the members of a ``sep``
ring, its merge kernel (``csrc/ring_flash.cu``) with the plain twin, and the
autograd Function that pairs the forward and backward rings.

Replaces the reference's ``ops/pallas/ring_flash.py``:
``ring_flash_attention`` (:159) with its forward core ``_rf_fwd_core``
(:64), backward core ``_rf_bwd_core`` (:108) and ``_merge`` (:47).  The
reference runs once per ring member inside a ``shard_map`` and rotates the
K/V chunks with ``ppermute``.  The port drives the ring from one process, as
the JAX engine's single controller does: it holds the ``n`` members' chunks,
runs each hop's flash kernel on the member's device, and moves a chunk to the
next member with a device copy.  Between two cards that is a peer copy;
between two members on one card it is nothing (``Tensor.to`` returns the
tensor itself), so one card runs the whole hop schedule.  PyTorch orders a
copy between cards after the work already queued on both cards' current
streams and before the work queued after it, so the next member's kernel
reads a chunk only once it has arrived.

Hop schedule: at hop ``i`` member ``r`` holds the chunk of ring position
``src = (r - i) mod n``.  Causal: ``src == r`` runs B3 with ``causal=True``,
``src < r`` runs it unmasked, and ``src > r`` launches nothing and merges
nothing; the reference merges zeros with lse -inf there, which is the
merge's identity.  Not causal: every pair runs unmasked.  A causal ring so
launches n(n+1)/2 flash kernels and n(n+1)/2 merges, n² of each without the
mask.  Each hop's output is B3's, in q's dtype, merged in f32 as the
reference's ``_merge`` does, so a bf16 ring rounds where the reference's
does.

Backward: every hop the forward ran runs B3b (dq and delta) and B3c (dk,
dv) with the forward's total out (in the input dtype, as the reference
saves it) and lse.  dq sums in f32 on its member; the f32 dK/dV
accumulators travel with their chunk and are home after n hops; the final
cast is to the input dtype.

Chunks: a sequence slice of a [b, s, h, d] tensor is contiguous only when
b == 1, and the kernels take a bf16 chunk only on a 16-byte boundary
(``flash_attention._check``).  Such a chunk is copied; ``COPIES`` counts
those copies (``chunk``) and the copies between devices (``peer``).

Bound on the H100: the hops do the work of one flash call over the whole
sequence, so the ring is bound as B3 (B3b/B3c backward) is, by operations;
the merge kernel is bound by bytes (see ``csrc/ring_flash.cu``), one pass
over the running f32 output a hop in place of XLA's fusion.

On CUDA tensors with ``use_flash_attention`` on, the ring launches B3,
B3b, B3c and the merge kernel, or raises; on CPU tensors, or with the flag
off, it runs the same schedule over the plain twins.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import torch

from . import _build, count_launch, use_kernel
from .flash_attention import (_DTYPES, flash_attention_bwd_dkv, flash_attention_bwd_dq,
                              flash_attention_bwd_plain, flash_attention_fwd,
                              flash_attention_plain)

__all__ = ["ring_merge_plain", "ring_merge", "hop_schedule", "split_chunks", "gather_chunks",
           "ring_flash_attention_fwd", "ring_flash_attention_bwd",
           "RingFlashAttentionFunction", "COPIES"]

DIAG, FULL, SKIP = "diag", "full", "skip"
COPIES: Dict[str, int] = {"chunk": 0, "peer": 0}
_MERGE_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_longlong,) + (ctypes.c_int,) * 4


def ring_merge_plain(o: torch.Tensor, lse: torch.Tensor, o_i: torch.Tensor,
                     lse_i: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge one hop's (o_i [b, c, hq, d] in q's dtype, lse_i [b, hq, c]
    f32) into the running (o [b, c, hq, d] f32, lse [b, hq, c] f32), in
    place: new = logaddexp(lse, lse_i), o = o·exp(lse − new) +
    float(o_i)·exp(lse_i − new), both weights 0 where new is −inf.
    Returns (o, lse)."""
    new = torch.logaddexp(lse, lse_i)
    dead = new == float("-inf")
    wa = torch.where(dead, 0.0, torch.exp(lse - new)).transpose(1, 2)[..., None]
    wb = torch.where(dead, 0.0, torch.exp(lse_i - new)).transpose(1, 2)[..., None]
    o.copy_(o * wa + o_i.float() * wb)
    lse.copy_(new)
    return o, lse


def ring_merge(o: torch.Tensor, lse: torch.Tensor, o_i: torch.Tensor,
               lse_i: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`ring_merge_plain` by the merge kernel on CUDA tensors, by the
    plain version on CPU tensors."""
    if not o.is_cuda:
        return ring_merge_plain(o, lse, o_i, lse_i)
    b, c, hq, d = o.shape
    if o.dtype != torch.float32 or o_i.dtype not in _DTYPES or o_i.shape != o.shape \
            or lse.shape != (b, hq, c) or lse_i.shape != lse.shape \
            or lse.dtype != torch.float32 or lse_i.dtype != torch.float32:
        raise ValueError(f"ring_merge: o f32 [b, c, hq, d], o_i f32 or bf16 of its "
                         f"shape, lse and lse_i f32 [b, hq, c]; got o {o.dtype} "
                         f"{tuple(o.shape)}, o_i {o_i.dtype} {tuple(o_i.shape)}, lse "
                         f"{tuple(lse.shape)}, lse_i {tuple(lse_i.shape)}")
    tensors = (o, lse, o_i, lse_i)
    if d % 4 or any(t.device != o.device or not t.is_contiguous() for t in tensors) \
            or o.data_ptr() % 16 or o_i.data_ptr() % (4 * o_i.element_size()):
        raise ValueError("ring_merge: contiguous tensors on one device, head_dim % 4 "
                         "== 0, o on 16 bytes and o_i on 4 elements")
    _build.launch("ring_flash", "ptt_ring_merge", _MERGE_ARGTYPES, o.device,
                  _build.ptr(o), _build.ptr(lse), _build.ptr(o_i), _build.ptr(lse_i),
                  b * c * hq, c, hq, d, _DTYPES[o_i.dtype])
    count_launch("ring_merge")
    return o, lse


def hop_schedule(n: int, causal: bool) -> List[List[str]]:
    """``[hop][member]``: what member r runs at hop i on the chunk of ring
    position (r − i) mod n: ``"diag"`` (causal B3), ``"full"`` (unmasked
    B3) or ``"skip"`` (nothing)."""
    def kind(r, src):
        if not causal:
            return FULL
        return DIAG if src == r else FULL if src < r else SKIP

    return [[kind(r, (r - i) % n) for r in range(n)] for i in range(n)]


def _to(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    if x.device == device:
        return x
    COPIES["peer"] += 1
    return x.to(device)


def split_chunks(x: torch.Tensor, members: Sequence[torch.device]) -> List[torch.Tensor]:
    """The n sequence chunks of ``x`` [b, s, h, d], chunk r on member r,
    each one contiguous and 16-byte aligned (a copy where the slice is
    not)."""
    n = len(members)
    c = x.shape[1] // n
    out = []
    for r, dev in enumerate(members):
        part = x[:, r * c:(r + 1) * c]
        if not part.is_contiguous() or part.data_ptr() % 16:
            part = part.clone(memory_format=torch.contiguous_format)
            COPIES["chunk"] += 1
        out.append(_to(part, dev))
    return out


def gather_chunks(chunks: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The chunks, concatenated along the sequence on ``device``."""
    return torch.cat([_to(t, device) for t in chunks], dim=1)


def _rotate(chunks: List[torch.Tensor]) -> List[torch.Tensor]:
    """One ring step: member r receives member r − 1's chunk."""
    n = len(chunks)
    return [_to(chunks[(r - 1) % n], chunks[r].device) for r in range(n)]


def ring_flash_attention_fwd(q: Sequence[torch.Tensor], k: Sequence[torch.Tensor],
                             v: Sequence[torch.Tensor], causal: bool
                             ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The forward ring over the members' chunks: q[r] [b, c, hq, d], k[r]
    and v[r] [b, c, hkv, d] on member r's device.  Returns each member's
    (out [b, c, hq, d] in q's dtype, lse [b, hq, c] f32)."""
    kernels = use_kernel("use_flash_attention", q[0])
    flash = flash_attention_fwd if kernels else flash_attention_plain
    merge = ring_merge if kernels else ring_merge_plain
    o = [torch.zeros(t.shape, dtype=torch.float32, device=t.device) for t in q]
    lse = [torch.full((t.shape[0], t.shape[2], t.shape[1]), float("-inf"),
                      dtype=torch.float32, device=t.device) for t in q]
    k_cur, v_cur = list(k), list(v)
    n = len(q)
    for i, hop in enumerate(hop_schedule(n, causal)):
        for r, kind in enumerate(hop):
            if kind != SKIP:
                merge(o[r], lse[r], *flash(q[r], k_cur[r], v_cur[r], kind == DIAG))
        if i < n - 1:
            k_cur, v_cur = _rotate(k_cur), _rotate(v_cur)
    return [t.to(x.dtype) for t, x in zip(o, q)], lse


def ring_flash_attention_bwd(q, k, v, out, lse, dout, causal: bool):
    """The backward ring: the members' chunks of q, k, v, the forward's
    out and lse and the output gradient ``dout``; returns the members'
    (dq, dk, dv) chunks in the input dtype."""
    kernels = use_kernel("use_flash_attention", q[0])
    dq = [torch.zeros(t.shape, dtype=torch.float32, device=t.device) for t in q]
    dk = [torch.zeros(t.shape, dtype=torch.float32, device=t.device) for t in k]
    dv = [torch.zeros(t.shape, dtype=torch.float32, device=t.device) for t in v]
    k_cur, v_cur = list(k), list(v)
    n = len(q)
    for i, hop in enumerate(hop_schedule(n, causal)):
        for r, kind in enumerate(hop):
            if kind == SKIP:
                continue
            args = (q[r], k_cur[r], v_cur[r])
            if kernels:
                dq_i, delta = flash_attention_bwd_dq(*args, out[r], lse[r], dout[r], kind == DIAG)
                dk_i, dv_i = flash_attention_bwd_dkv(*args, dout[r], lse[r], delta, kind == DIAG)
            else:
                dq_i, dk_i, dv_i = flash_attention_bwd_plain(*args, out[r], lse[r], dout[r],
                                                             kind == DIAG)
            dq[r] += dq_i
            dk[r] += dk_i
            dv[r] += dv_i
        # the dK/dV accumulators travel with their chunk: after n steps each
        # is home with every member's contribution
        dk, dv = _rotate(dk), _rotate(dv)
        if i < n - 1:
            k_cur, v_cur = _rotate(k_cur), _rotate(v_cur)
    return ([t.to(x.dtype) for t, x in zip(dq, q)], [t.to(x.dtype) for t, x in zip(dk, k)],
            [t.to(x.dtype) for t, x in zip(dv, v)])


class RingFlashAttentionFunction(torch.autograd.Function):
    """Global q [b, s, hq, d], k/v [b, s, hkv, d] on one device, split into
    sequence chunks over ``members`` (a list of ``torch.device``, one per
    ring position; repeats allowed); returns the global out on q's device.
    Saves each member's chunks, out and lse."""

    @staticmethod
    def forward(ctx, q, k, v, members: Sequence[torch.device], causal: bool):
        chunks = [split_chunks(t, members) for t in (q, k, v)]
        out, lse = ring_flash_attention_fwd(*chunks, causal)
        ctx.save_for_backward(*chunks[0], *chunks[1], *chunks[2], *out, *lse)
        ctx.members, ctx.causal = list(members), causal
        return gather_chunks(out, q.device)

    @staticmethod
    def backward(ctx, dout):
        n = len(ctx.members)
        saved = ctx.saved_tensors
        q, k, v, out, lse = (list(saved[j * n:(j + 1) * n]) for j in range(5))
        grads = ring_flash_attention_bwd(q, k, v, out, lse,
                                         split_chunks(dout, ctx.members), ctx.causal)
        return (*(gather_chunks(g, dout.device) for g in grads), None, None)
