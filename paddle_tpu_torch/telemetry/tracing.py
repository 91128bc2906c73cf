"""Distributed request tracing: one ``trace_id`` across the fleet.

Dapper/OpenTelemetry-style span propagation for the serving stack: a
16-hex ``trace_id`` is minted once, at the edge (``ServingFrontend.submit``
or a standalone ``ServingEngine.submit``), and then *carried* — in the
journal submit record, in every depot frame the journal ships, in the
hand-back descriptor a draining replica returns, and in the re-submit a
fail-over makes to a survivor — so the spans a request leaves behind
(``serve_submit → serve_route → serve_admit → serve_first_token[prefill]
→ serve_token[decode] → serve_deliver → serve_finish``, plus
``serve_evict`` / ``serve_replay`` detours) share one id no matter how
many processes, evictions, fencings or replays the request lived through.

Spans are ordinary flight-recorder events with a ``trace`` key: no new
storage, no sampling daemon — the existing ring, dumps and the profiler's
chrome-trace merge carry them.  This module is the stdlib-only toolkit
around that convention:

- :func:`mint` — make a trace id (also graciously accepts an existing one
  so replay paths can write ``trace_id = mint(rec.get("trace_id"))``).
- :func:`spans` — filter an event stream down to one trace (or all traced
  events), in recorded order.
- :func:`trace_ids` — every distinct trace seen in an event stream.
- :func:`trace_coverage` — the CI gate: the fraction of finished requests
  whose span chain is complete under a single trace id.
- :func:`chrome_trace_events` — traced spans as chrome-trace JSON entries
  (cat ``trace``), mergeable into ``Profiler.export`` output and openable
  in Perfetto next to the host/telemetry tracks.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterable, List, Optional, Sequence, Set

__all__ = ["TRACE_KEY", "REQUIRED_SPANS", "mint", "spans", "trace_ids",
           "trace_coverage", "chrome_trace_events"]

# the event-dict key a span's trace id rides under (short on purpose —
# it appears on every serve_*/fleet_* event of a traced request)
TRACE_KEY = "trace"

# the minimal span chain every *finished* request must have left behind:
# submit -> admit -> prefill (first token) -> finish.  route/deliver/decode
# spans are present too but depend on path (a standalone engine has no
# router; a zero-decode request has no serve_token).
REQUIRED_SPANS = ("serve_submit", "serve_admit", "serve_first_token",
                  "serve_finish")


def mint(existing: Optional[str] = None) -> str:
    """A new 16-hex trace id — or ``existing`` passed through, so every
    replay/fail-over site can uniformly write ``mint(rec.get('trace_id'))``
    and never fork a request onto a second trace."""
    if existing:
        return str(existing)
    return os.urandom(8).hex()


def spans(events: Iterable[Dict[str, Any]],
          trace_id: Optional[str] = None) -> List[Dict[str, Any]]:
    """Events carrying a trace id (all of them, or just ``trace_id``'s),
    in the order given."""
    out = []
    for ev in events:
        t = ev.get(TRACE_KEY)
        if t is None:
            continue
        if trace_id is not None and t != trace_id:
            continue
        out.append(ev)
    return out


def trace_ids(events: Iterable[Dict[str, Any]]) -> List[str]:
    """Distinct trace ids in an event stream, in first-seen order."""
    seen: Dict[str, None] = {}
    for ev in events:
        t = ev.get(TRACE_KEY)
        if t is not None and t not in seen:
            seen[t] = None
    return list(seen)


def _chains(events: Iterable[Dict[str, Any]]) -> Dict[str, Set[str]]:
    """trace_id -> set of span kinds seen under it."""
    chains: Dict[str, Set[str]] = {}
    for ev in events:
        t = ev.get(TRACE_KEY)
        if t is None:
            continue
        chains.setdefault(str(t), set()).add(ev.get("kind", ""))
    return chains


def trace_coverage(events: Iterable[Dict[str, Any]],
                   finished_rids: Optional[Sequence[object]] = None,
                   required: Sequence[str] = REQUIRED_SPANS) -> float:
    """Fraction of finished requests with a complete span chain.

    With ``finished_rids``: for each rid, its ``serve_finish`` event names
    the trace, and that trace must carry every ``required`` span kind.
    Without rids: every trace that reached ``serve_finish`` is graded.
    1.0 means no finished request lost its trace anywhere along
    submit/evict/replay/fail-over; an empty denominator is vacuously 1.0.
    """
    events = list(events)
    chains = _chains(events)
    if finished_rids is not None:
        finish_trace: Dict[str, str] = {}
        for ev in events:
            if ev.get("kind") == "serve_finish" and \
                    ev.get(TRACE_KEY) is not None:
                finish_trace[str(ev.get("name"))] = str(ev[TRACE_KEY])
        rids = [str(r) for r in finished_rids]
        if not rids:
            return 1.0
        ok = 0
        for rid in rids:
            t = finish_trace.get(rid)
            if t is not None and set(required) <= chains.get(t, set()):
                ok += 1
        return ok / len(rids)
    finished = [t for t, kinds in chains.items() if "serve_finish" in kinds]
    if not finished:
        return 1.0
    ok = sum(1 for t in finished if set(required) <= chains[t])
    return ok / len(finished)


def chrome_trace_events(events: Iterable[Dict[str, Any]],
                        pid: Optional[object] = None) -> List[dict]:
    """Traced spans as chrome-trace entries (instant marks on a per-trace
    track, cat ``trace``) — append to a ``Profiler.export`` document's
    ``traceEvents`` and the request's life lines up against the host and
    telemetry tracks in Perfetto."""
    out = []
    for ev in spans(events):
        mono = ev.get("mono_ns")
        if mono is None:
            continue
        args = {k: v for k, v in ev.items()
                if k not in ("kind", "name", "mono_ns", "ts")}
        out.append({
            "name": f"{ev.get('kind')}:{ev.get('name')}",
            "ph": "i", "s": "t",
            "pid": os.getpid() if pid is None else pid,
            "tid": f"trace:{ev[TRACE_KEY]}",
            "ts": mono / 1e3, "cat": "trace", "args": args,
        })
    return out
