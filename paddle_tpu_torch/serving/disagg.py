"""Disaggregated serving (port of the reference's ``serving/disagg.py``):
tensor-parallel decode's placement, the prefill tier and its KV frames.

**Tensor-parallel decode** (``decode_mesh``, ``shard_llama_params``,
``arena_partition_spec``, ``shard_arenas``).

The reference commits a ``ServingEngine``'s parameters and KV arenas onto a
1-D ``"model"`` mesh with ``NamedSharding`` and lets GSPMD run the Megatron
decomposition.  The port's engine drives the members from one process
(``ServingEngine(tp=n)``), so placement here is explicit:

- a member is a position on the ``model`` axis; members go round-robin over
  the devices given (default: the visible devices of the default type), so
  several may share one card, as the context-parallel ring's do;
- a Megatron-split parameter (paddle ``[in, out]`` layout: q/k/v/gate/up
  split their out dim, o/down their in dim) keeps its global tensor and
  gains ``shards``, one a member: a view of the parameter for a member on
  the parameter's device (no memory), a resident copy on any other;
  ``split_axis`` and ``is_distributed`` mark it, as in the reference.
  Everything else (embeddings, norms, the LM head, the rope tables) stays
  whole on the model's device, where the engine computes it once;
- a KV arena is split along its kv-head axis into one contiguous resident
  tensor a member.

**The prefill tier.** :class:`PrefillWorker` owns an engine whose only
job is :meth:`~.engine.ServingEngine.prefill_export`: it runs a prompt's
prefill, streams the finished pages to the depot as framed ``kv_put``\\ s
(:func:`pack_kv_frame`: a JSON header naming each plane's numpy dtype and
shape, then the raw bytes, so a frame either package packed unpacks in the
other), then ``kv_commit``.  The commit is the exactly-once gate: a worker
that dies mid-stream leaves nothing claimable, and the fleet's fencing
refuses a zombie's late frames.  A decode engine claims a committed rid
once (:func:`take_prefilled`, the one-shot ``kv_take``) and imports the
frames through ``submit_prefilled``; its journal then owns the request as
if it had been submitted locally.

**The coordinator.** :class:`DisaggCoordinator` is the tiered submit
plane: prompts of at least ``PADDLE_TPU_DISAGG_MIN_PROMPT`` tokens go
through a prefill worker, the rest straight to decode.  A failure on the
prefill leg fences the worker's epoch at the depot and replays the request
as a decode-local prefill (``fallbacks`` counts them, each with a
``disagg_fallback`` event).

Env knobs: ``PADDLE_TPU_DISAGG_MIN_PROMPT`` (routing threshold in tokens,
default ``4 * page_tokens``), ``PADDLE_TPU_DISAGG_TTL`` (seconds a
coordinator waits on a committed rid's frames before falling back,
default 5).
"""

from __future__ import annotations

import io
import json
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import devices as _visible_devices
from ..distributed.checkpoint import faults as _faults
from ..distributed.checkpoint.replicator import FencedEpoch, env_int as _env_int
from ..distributed.topology import Mesh, _HYBRID_AXES, _indexed
from ..telemetry import record_event as _event
from ..telemetry.runtime import bump as _bump
from .admission import Deadline

__all__ = ["decode_mesh", "shard_llama_params", "arena_partition_spec", "shard_arenas",
           "pack_kv_frame", "unpack_kv_frame", "disagg_ttl", "default_min_prompt",
           "PrefillWorker", "take_prefilled", "DisaggCoordinator"]

# paddle Linear weight layout is [in, out]: column-parallel projections
# (q/k/v, gate/up) split the OUT dim, row-parallel ones (o, down) the IN
# dim; matching is on the dotted parameter name's suffix
_COL_SUFFIXES = ("q_proj.weight", "k_proj.weight", "v_proj.weight",
                 "gate_proj.weight", "up_proj.weight")
_ROW_SUFFIXES = ("o_proj.weight", "down_proj.weight")


def decode_mesh(tp: int, *, devices=None) -> Mesh:
    """A mesh whose ``model`` axis has ``tp`` members, member i on
    ``devices[i mod len(devices)]`` (default: the visible devices of the
    default type).  The reference needs ``tp`` devices and raises with
    fewer; one process drives the port's members, so they wrap."""
    devs = [_indexed(d) for d in (devices if devices is not None else _visible_devices())]
    if tp < 1 or not devs:
        raise ValueError(f"decode_mesh: tp={tp} over {len(devs)} device(s)")
    arr = np.empty(tp, dtype=object)
    arr[:] = [devs[i % len(devs)] for i in range(tp)]
    return Mesh(arr.reshape(1, 1, 1, 1, tp), _HYBRID_AXES)


def shard_llama_params(model, mesh) -> int:
    """Give every Megatron-split parameter of a llama-family ``model`` its
    member shards over ``mesh``'s ``model`` axis (``p.shards``, with
    ``split_axis`` and ``is_distributed``; module docstring).  Returns the
    number of split parameters.  In place, as the reference's: shards are
    views of the parameters, and a later call with another mesh replaces
    them, so an engine keeps the shards it was built with."""
    members = mesh.axis_devices("model")
    n = len(members)
    sharded = 0
    for name, p in model.named_parameters():
        if name.endswith(_COL_SUFFIXES):
            axis = 1
        elif name.endswith(_ROW_SUFFIXES):
            axis = 0
        else:
            continue
        if p.shape[axis] % n:
            raise ValueError(f"{name}: dim {axis} of {tuple(p.shape)} does not "
                             f"split over {n} members")
        w = p.shape[axis] // n
        p.shards = [p.detach().narrow(axis, j * w, w).to(dev)
                    for j, dev in enumerate(members)]
        p.split_axis, p.is_distributed = axis, True
        sharded += 1
    return sharded


def arena_partition_spec(key: str):
    """The axes of one arena plane, with the kv-head axis named
    ``"model"``: k/v pages ``[pages, page_tokens, kv_heads, head_dim]``,
    int8 scale planes ``[pages, page_tokens, kv_heads]`` (the reference's
    ``PartitionSpec`` as a tuple)."""
    if key in ("ks", "vs"):
        return (None, None, "model")
    return (None, None, "model", None)


def shard_arenas(arenas: Dict[str, list], mesh) -> List[Dict[str, list]]:
    """Split every arena of ``arenas`` ({plane: [one tensor a layer]})
    along its kv-head axis over ``mesh``'s ``model`` members: one dict a
    member, each plane's tensors contiguous and resident on the member's
    device."""
    members = mesh.axis_devices("model")
    n = len(members)
    out = [{} for _ in members]
    for key, arrs in arenas.items():
        axis = arena_partition_spec(key).index("model")
        for j, dev in enumerate(members):
            parts = []
            for a in arrs:
                w = a.shape[axis] // n
                parts.append(a.narrow(axis, j * w, w).to(dev).contiguous())
            out[j][key] = parts
    return out


# -- KV page frames (the depot's wire format) ---------------------------------

# numpy's dtype names of the planes (bf16 and e4m3 are ml_dtypes' names)
_PLANE_DTYPES = {torch.bfloat16: "bfloat16", torch.float8_e4m3fn: "float8_e4m3fn",
                 torch.float16: "float16", torch.float32: "float32", torch.int8: "int8"}
_TORCH_DTYPES = {name: dt for dt, name in _PLANE_DTYPES.items()}


def _plane_bytes(x) -> Tuple[str, List[int], bytes]:
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        return _PLANE_DTYPES[t.dtype], list(t.shape), t.view(torch.uint8).numpy().tobytes()
    a = np.ascontiguousarray(x)
    return str(a.dtype), list(a.shape), a.tobytes()


def pack_kv_frame(frame: Dict[str, object]) -> bytes:
    """One page's planes -> depot payload: a JSON header (each plane's
    numpy dtype name and shape) and the raw buffers, concatenated in
    sorted-key order.  The planes may be torch tensors or numpy arrays.
    The depot's framing carries the CRC; this format only needs to
    describe itself."""
    keys = sorted(frame)
    planes = {k: _plane_bytes(frame[k]) for k in keys}
    head = {k: {"dtype": planes[k][0], "shape": planes[k][1]} for k in keys}
    buf = io.BytesIO()
    hb = json.dumps(head).encode()
    buf.write(len(hb).to_bytes(4, "big"))
    buf.write(hb)
    for k in keys:
        buf.write(planes[k][2])
    return buf.getvalue()


def unpack_kv_frame(data: bytes) -> Dict[str, torch.Tensor]:
    """A packed frame as a dict of host tensors."""
    n = int.from_bytes(data[:4], "big")
    head = json.loads(data[4:4 + n].decode())
    out: Dict[str, torch.Tensor] = {}
    off = 4 + n
    for k in sorted(head):
        dt = _TORCH_DTYPES[head[k]["dtype"]]
        shape = tuple(head[k]["shape"])
        nbytes = dt.itemsize * int(np.prod(shape)) if shape else dt.itemsize
        if off + nbytes > len(data):
            raise ValueError(f"kv frame payload truncated: plane {k!r} needs "
                             f"{nbytes} bytes at {off} of {len(data)}")
        raw = torch.frombuffer(bytearray(data[off:off + nbytes]), dtype=torch.uint8)
        out[k] = raw.view(dt).reshape(shape)
        off += nbytes
    if off != len(data):
        raise ValueError(f"kv frame payload size mismatch: consumed "
                         f"{off} of {len(data)} bytes")
    return out


# -- prefill tier -----------------------------------------------------------

def disagg_ttl() -> float:
    """How long a coordinator polls a routed rid's committed frames
    before executing the fallback ladder (``PADDLE_TPU_DISAGG_TTL``,
    seconds, default 5).  With in-process workers the commit is visible
    on the first take; the TTL only matters when the prefill worker runs
    remotely and its ``kv_commit`` races the coordinator's claim."""
    return float(os.environ.get("PADDLE_TPU_DISAGG_TTL", "5") or 5)


def default_min_prompt(page_tokens: int) -> int:
    """Routing threshold: prompts at/above this many tokens go to the
    prefill tier (``PADDLE_TPU_DISAGG_MIN_PROMPT``, default 4 pages —
    short prompts aren't worth a network round trip)."""
    return _env_int("PADDLE_TPU_DISAGG_MIN_PROMPT", 4 * page_tokens)


class PrefillWorker:
    """One prefill-tier worker: an engine used ONLY for
    ``prefill_export``, an adopted fencing epoch, and a depot to stream
    into.  Construction fences the previous incarnation (the fleet's
    ``adopt_epoch`` idiom), so a SIGKILL'd worker's restart immediately
    invalidates any half-streamed rid the old incarnation left."""

    def __init__(self, engine, depot, *, name: str = "prefill0",
                 epoch: Optional[int] = None):
        from .fleet import adopt_epoch

        self.engine = engine
        self.depot = depot
        self.name = str(name)
        self.epoch = int(epoch) if epoch is not None \
            else adopt_epoch(depot, self.name)
        self.prefills_total = 0
        self.tokens_prefilled = 0

    def prefill(self, prompt, *, rid: int, max_new_tokens: int = 64,
                eos_token_id: Optional[int] = None,
                deadline: Optional[Deadline] = None,
                age_s: float = 0.0,
                trace_id: Optional[str] = None) -> dict:
        """Prefill ``prompt``, stream its KV pages to the depot, COMMIT,
        and return the commit meta (the decode side's claim ticket).
        The ``disagg_stream`` chaos seam fires before every frame put —
        a worker "dying" mid-stream raises out of here with the rid
        uncommitted, which is exactly the state a real SIGKILL leaves."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        first, frames = self.engine.prefill_export(prompt)
        meta = {"rid": int(rid), "prompt": [int(t) for t in prompt],
                "first_token": int(first), "n_frames": len(frames),
                "max_new_tokens": int(max_new_tokens),
                "eos_token_id": (None if eos_token_id is None
                                 else int(eos_token_id)),
                "deadline": (None if deadline is None
                             else deadline.to_doc()),
                "age_s": float(age_s), "trace_id": trace_id,
                "kv_dtype": self.engine.kv_dtype,
                "worker": self.name, "epoch": self.epoch}
        for idx, f in enumerate(frames):
            _faults.fire("disagg_stream",
                         f"{self.name}/rid{rid}/frame{idx}")
            self.depot.kv_put(self.name, self.epoch, int(rid), idx,
                              pack_kv_frame(f))
        self.depot.kv_commit(self.name, self.epoch, int(rid), meta)
        self.prefills_total += 1
        self.tokens_prefilled += int(prompt.size)
        _event("disagg_prefill", str(rid), worker=self.name,
               epoch=self.epoch, pages=len(frames), trace=trace_id)
        _bump("serving.disagg_prefills_total")
        return meta


def take_prefilled(depot, replica: str, epoch: int,
                   rid: int) -> Optional[Tuple[dict, List[dict]]]:
    """Claim one committed rid exactly once and fetch its frames.
    Returns ``(meta, frames)`` for the FIRST caller, ``None`` when the
    rid is uncommitted/already claimed, or when a frame was pruned (the
    claim is burned but the meta's journaled prompt lets the caller
    fall back to a local prefill — still exactly-once: no tokens were
    emitted yet)."""
    meta = depot.kv_take(replica, epoch, rid)
    if meta is None:
        return None
    frames: List[dict] = []
    for idx in range(int(meta.get("n_frames", 0))):
        data = depot.kv_get(replica, epoch, rid, idx)
        if data is None:
            _event("disagg_frames_lost", str(rid), worker=replica,
                   epoch=epoch, frame=idx)
            return None
        frames.append(unpack_kv_frame(data))
    return meta, frames


class DisaggCoordinator:
    """Tiered submit plane over one decode engine + N prefill workers.

    ``submit`` is the single entry point: long prompts take the prefill
    leg (worker prefill → depot stream → commit → one-shot take →
    ``submit_prefilled``), short prompts go straight to decode.  Any
    failure on the prefill leg executes the fence → fold → replay
    ladder: the worker's epoch is fenced at the depot (a zombie's
    in-flight puts/commits are refused from that instant), and the
    request replays as a decode-local prefill.  Exactly-once holds by
    construction — no token is ever emitted before the decode engine
    journals the request, whichever leg admitted it."""

    def __init__(self, decode_engine, prefill_workers, depot, *,
                 min_prompt: Optional[int] = None):
        self.decode = decode_engine
        self.workers: List[PrefillWorker] = list(prefill_workers)
        self.depot = depot
        self.min_prompt = int(min_prompt) if min_prompt is not None \
            else default_min_prompt(decode_engine.page_tokens)
        self._rr = 0
        self.prefill_routed = 0
        self.decode_direct = 0
        self.fallbacks = 0

    def _next_rid(self) -> int:
        from .engine import Request

        rid = Request._next_rid
        Request._next_rid += 1
        return rid

    def submit(self, prompt, max_new_tokens: int = 64,
               eos_token_id: Optional[int] = None, *,
               deadline: Optional[Deadline] = None,
               age_s: float = 0.0,
               trace_id: Optional[str] = None) -> int:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if self.workers and prompt.size >= self.min_prompt:
            rid = self._next_rid()
            w = self.workers[self._rr % len(self.workers)]
            self._rr += 1
            try:
                w.prefill(prompt, rid=rid,
                          max_new_tokens=max_new_tokens,
                          eos_token_id=eos_token_id, deadline=deadline,
                          age_s=age_s, trace_id=trace_id)
                got = take_prefilled(self.depot, w.name, w.epoch, rid)
                wait_until = time.monotonic() + disagg_ttl()
                while got is None and time.monotonic() < wait_until:
                    time.sleep(0.02)
                    got = take_prefilled(self.depot, w.name, w.epoch,
                                         rid)
                if got is not None:
                    meta, frames = got
                    self.prefill_routed += 1
                    _bump("serving.disagg_routed_total")
                    return self.decode.submit_prefilled(
                        meta["prompt"], meta["first_token"], frames,
                        max_new_tokens=meta["max_new_tokens"],
                        eos_token_id=meta["eos_token_id"],
                        deadline=Deadline.from_doc(meta["deadline"]),
                        rid=rid, age_s=age_s, trace_id=trace_id)
                reason = "frames_unclaimable"
            except (FencedEpoch, OSError, RuntimeError) as e:
                reason = f"{type(e).__name__}: {e}"
            # fence → fold → replay: declare the worker's incarnation
            # dead so its late puts/commits change nothing, then replay
            # the request as a decode-local prefill.  (Fold here is
            # trivial — nothing uncommitted is ever claimable, and the
            # one-shot take already burned any claim we made.)
            try:
                w.epoch = self.depot.fence(w.name, w.epoch + 1)
            except OSError:
                pass       # depot unreachable: local prefill still safe
            self.fallbacks += 1
            _event("disagg_fallback", str(rid), worker=w.name,
                   reason=str(reason)[:200], trace=trace_id)
            _bump("serving.disagg_fallbacks_total")
            return self.decode.submit(prompt, max_new_tokens,
                                      eos_token_id, deadline=deadline,
                                      rid=rid, age_s=age_s,
                                      trace_id=trace_id)
        self.decode_direct += 1
        return self.decode.submit(prompt, max_new_tokens, eos_token_id,
                                  deadline=deadline, age_s=age_s,
                                  trace_id=trace_id)

    def summary(self) -> dict:
        return {"prefill_routed": self.prefill_routed,
                "decode_direct": self.decode_direct,
                "fallbacks": self.fallbacks,
                "min_prompt": self.min_prompt,
                "workers": [w.name for w in self.workers]}
