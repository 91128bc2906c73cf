"""Black-box timeline merge: N flight-recorder dumps -> one causal story.

A chaos post-mortem today means opening one JSON dump per process and
eyeballing wall clocks.  This module folds every flight-recorder dump in
an epoch dir (the launcher's ``log_dir`` — per-rank crash dumps, the
periodic spills :class:`aggregator.MetricsPusher` leaves behind for
SIGKILL'd replicas, and the launcher's own ring with its ``gang`` /
``supervisor`` events) into ONE merged, causally ordered timeline.

Ordering is two-layered:

1. **Clock alignment.**  Every event carries a wall stamp (``ts``) and a
   monotonic stamp (``mono_ns``).  Within a process the monotonic clock
   is the truth (wall can step under NTP); across processes only wall is
   comparable.  Per dump we estimate ``offset = median(ts - mono_ns/1e9)``
   and place each event at ``offset + mono_ns/1e9`` — NTP steps inside a
   process are ironed out, cross-process skew reduces to one offset per
   process.
2. **Happens-before edges.**  Wall clocks across hosts can still disagree
   by more than an event gap, so store interactions pin the order where
   physics does: a journal segment's ship (``fleet_ship`` seq *s* at the
   depot) happened before any fold that consumed it (``fleet_fold`` of
   the same replica+epoch with ``high_seq >= s``), and a replica's fence
   (``fleet_fence``) precedes the fold that follows it.  Per-process
   event order is always preserved.  The merge is a stable topological
   sort (Kahn over per-process chains + store edges, heap-ordered by
   aligned time), so a skewed clock can never show an effect before its
   cause.

``merge(epoch_dir)`` returns the merged doc and writes it next to the
inputs as ``blackbox_merged.json``.  Stdlib-only; dumps are read
tolerantly (a truncated dump from a dying process is skipped, not fatal).
"""

from __future__ import annotations

import glob
import heapq
import json
import os
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["merge", "load_dumps", "order_events"]

MERGED_NAME = "blackbox_merged.json"


def load_dumps(epoch_dir: str) -> List[Dict[str, Any]]:
    """Every readable ``flight_*.json`` dump doc under ``epoch_dir``
    (merged outputs and temp spills excluded), each tagged with its
    ``_file``."""
    docs = []
    for path in sorted(glob.glob(os.path.join(epoch_dir, "flight_*.json"))):
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue  # torn spill from a dying process: skip, don't fail
        if not isinstance(doc, dict) or not isinstance(
                doc.get("events"), list):
            continue
        doc["_file"] = os.path.basename(path)
        docs.append(doc)
    return docs


def _src_name(doc: Dict[str, Any]) -> str:
    ident = doc.get("identity") or {}
    for key in ("replica", "rank"):
        if ident.get(key) is not None:
            tag = ident[key]
            return str(tag) if key == "replica" else f"rank{tag}"
    return f"{doc.get('host', '?')}:pid{doc.get('pid', '?')}"


def _offset(events: List[Dict[str, Any]]) -> Optional[float]:
    """Median wall-minus-mono offset: the per-process mono->wall mapping,
    robust to a minority of NTP-stepped wall stamps."""
    deltas = sorted(e["ts"] - e["mono_ns"] / 1e9 for e in events
                    if e.get("ts") is not None and e.get("mono_ns")
                    is not None)
    if not deltas:
        return None
    return deltas[len(deltas) // 2]


def _edges(events: List[Tuple[int, Dict[str, Any]]]
           ) -> List[Tuple[int, int]]:
    """Store-interaction happens-before edges between globally indexed
    events: ship(replica, epoch, seq) -> fold(replica, epoch) consuming
    seq, and fence(replica, epoch) -> that fold."""
    ships: Dict[Tuple[str, int], List[Tuple[int, int]]] = {}
    fences: Dict[Tuple[str, int], List[int]] = {}
    folds: List[Tuple[int, str, int, int]] = []
    for idx, ev in events:
        kind = ev.get("kind")
        if kind == "fleet_ship":
            key = (str(ev.get("name")), int(ev.get("epoch", 0)))
            ships.setdefault(key, []).append((int(ev.get("seq", 0)), idx))
        elif kind == "fleet_fence":
            key = (str(ev.get("name")), int(ev.get("epoch", 0)))
            fences.setdefault(key, []).append(idx)
        elif kind == "fleet_fold":
            folds.append((idx, str(ev.get("name")),
                          int(ev.get("epoch", 0)),
                          int(ev.get("high_seq", -1))))
    out: List[Tuple[int, int]] = []
    for fold_idx, name, epoch, high_seq in folds:
        for seq, ship_idx in ships.get((name, epoch), ()):
            if high_seq < 0 or seq <= high_seq:
                out.append((ship_idx, fold_idx))
        for fence_idx in fences.get((name, epoch), ()):
            if fence_idx != fold_idx:
                out.append((fence_idx, fold_idx))
    return out


def order_events(per_process: Dict[str, List[Dict[str, Any]]]
                 ) -> List[Dict[str, Any]]:
    """Merge per-process event lists into one causally ordered list.

    Constraints: each process's own order, plus store edges.  Among
    unconstrained events the heap pops by aligned wall time, so the
    result is the natural interleaving except where causality overrides
    a skewed clock."""
    indexed: List[Tuple[str, Dict[str, Any], float]] = []
    for src in sorted(per_process):
        events = per_process[src]
        off = _offset(events)
        for pos, ev in enumerate(events):
            if off is not None and ev.get("mono_ns") is not None:
                t = off + ev["mono_ns"] / 1e9
            else:
                t = ev.get("ts", 0.0) or 0.0
            indexed.append((src, ev, t))
    n = len(indexed)
    succ: List[List[int]] = [[] for _ in range(n)]
    pred_n = [0] * n
    # per-process chains
    last_by_src: Dict[str, int] = {}
    for i, (src, _ev, _t) in enumerate(indexed):
        if src in last_by_src:
            succ[last_by_src[src]].append(i)
            pred_n[i] += 1
        last_by_src[src] = i
    # store edges
    for a, b in _edges([(i, ev) for i, (_s, ev, _t) in enumerate(indexed)]):
        succ[a].append(b)
        pred_n[b] += 1
    heap = [(indexed[i][2], i) for i in range(n) if pred_n[i] == 0]
    heapq.heapify(heap)
    out: List[Dict[str, Any]] = []
    while heap:
        t, i = heapq.heappop(heap)
        src, ev, _ = indexed[i]
        merged = dict(ev)
        merged["src"] = src
        merged["t"] = round(t, 6)
        out.append(merged)
        for j in succ[i]:
            pred_n[j] -= 1
            if pred_n[j] == 0:
                heapq.heappush(heap, (max(indexed[j][2], t), j))
    if len(out) != n:  # a cycle (conflicting dumps): fall back to time order
        out = sorted((dict(ev, src=src, t=round(t, 6))
                      for src, ev, t in indexed), key=lambda e: e["t"])
    return out


def merge(epoch_dir: str, out_path: Optional[str] = None) -> Dict[str, Any]:
    """Fold every dump under ``epoch_dir`` into one merged timeline doc
    and write it (default ``<epoch_dir>/blackbox_merged.json``)."""
    dumps = load_dumps(epoch_dir)
    per_process: Dict[str, List[Dict[str, Any]]] = {}
    processes = []
    for doc in dumps:
        src = _src_name(doc)
        # two dumps from the same process (periodic spill + crash dump):
        # fold them into one stream, deduped by (mono_ns, kind, name)
        bucket = per_process.setdefault(src, [])
        seen = {(e.get("mono_ns"), e.get("kind"), e.get("name"))
                for e in bucket}
        for ev in doc["events"]:
            key = (ev.get("mono_ns"), ev.get("kind"), ev.get("name"))
            if key in seen:
                continue
            seen.add(key)
            bucket.append(ev)
        processes.append({"file": doc["_file"], "src": src,
                          "host": doc.get("host"), "pid": doc.get("pid"),
                          "reason": doc.get("reason"),
                          "events": len(doc["events"])})
    for events in per_process.values():
        events.sort(key=lambda e: e.get("mono_ns") or 0)
    merged = {
        "epoch_dir": os.path.abspath(epoch_dir),
        "processes": processes,
        "events": order_events(per_process),
    }
    if out_path is None:
        out_path = os.path.join(epoch_dir, MERGED_NAME)
    try:
        with open(out_path, "w") as f:
            json.dump(merged, f, indent=1, default=repr)
        merged["path"] = out_path
    except OSError:
        merged["path"] = None
    return merged
