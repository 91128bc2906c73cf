"""Crash-recovery journal of the serving engine (port of the reference's
``serving/journal.py``, same segment and record format: a journal written
by either package folds in the other).

What must survive a crash of a serving process is the request ledger:
which requests were accepted, which tokens each client was already shown,
which were shed.  This module persists exactly that, and replays it into a
fresh engine so that every accepted request completes exactly once,
token-exact (greedy decode is deterministic: the new engine regenerates the
same stream, and the journal says where the client's high-water mark was).

- :meth:`ServingJournal.record` buffers records; :meth:`~ServingJournal.
  flush` writes them as ONE new ``seg_<n>.json`` through
  ``distributed.checkpoint.storage.write_bytes`` (tmp + fsync + rename,
  with retries).  A crash mid-flush leaves the earlier segments intact: the
  engine hands tokens to its sink only AFTER the covering flush, so the
  lost tokens were never shown and are regenerated and delivered once.
- Records: ``submit`` (prompt, decode parameters, deadline: durable at
  admission), ``deliver`` (rid, token index, token: the delivered
  high-water mark), ``finish``, ``shed``.
- :meth:`~ServingJournal.load_state` folds the segments.  A torn segment
  stops the fold at the previous segment boundary and is quarantined with
  every later one: recovery falls back to an EARLIER high-water mark,
  which is safe (the sink drops re-emissions, regenerated tokens are the
  same).

:class:`TokenSink` is the matching exactly-once client channel: an
append-only JSONL of ``(rid, idx, token)`` that reloads its own high-water
marks on restart and drops re-emissions at or below them.

The reference also counts corrupt segments in its telemetry layer (ROADMAP
A8): here ``JournalState.truncated`` says that the fold stopped early.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional, Set

from ..distributed.checkpoint.storage import read_bytes, write_bytes

__all__ = ["ServingJournal", "JournalState", "TokenSink"]

_SEG_FMT = "seg_{:08d}.json"


class JournalState:
    """Folded view of a journal: what a relaunched engine must know."""

    def __init__(self):
        self.requests: Dict[int, dict] = {}    # rid -> submit record
        self.delivered: Dict[int, List[int]] = {}  # rid -> tokens, in order
        self.finished: Set[int] = set()
        self.shed: Dict[int, str] = {}         # rid -> reason
        self.segments_read = 0
        self.truncated = False                 # stopped at a corrupt segment

    def open_rids(self) -> List[int]:
        """Accepted requests that neither finished nor were shed — the ones
        a relaunch must replay, in admission order."""
        return [rid for rid in self.requests
                if rid not in self.finished and rid not in self.shed]


class ServingJournal:
    """Append-only request ledger under ``root`` (a directory).

    Buffer and flush are lock-protected: a forever-mode engine flushes
    from its serving thread while :meth:`submit_durable` runs on client
    threads — without the lock two concurrent flushes would race on the
    same segment number and one thread's records would vanish."""

    def __init__(self, root: str, ship=None):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)
        self._lock = threading.Lock()
        self._pending: List[dict] = []
        self._next_seg = self._scan_next_seg()
        # optional segment shipper ``ship(seq, data)`` — the fleet wires a
        # depot put here so every flushed segment reaches the launcher's
        # depot BEFORE the covering tokens can be emitted (depot view >=
        # client view; see _flush_locked for the ordering contract)
        self._ship = ship

    def _scan_next_seg(self) -> int:
        last = -1
        try:
            for name in os.listdir(self.root):
                if name.startswith("seg_") and name.endswith(".json"):
                    try:
                        last = max(last, int(name[4:-5]))
                    except ValueError:
                        continue
        except FileNotFoundError:
            pass
        return last + 1

    # -- writing -----------------------------------------------------------
    def record(self, rtype: str, **fields) -> None:
        with self._lock:
            self._pending.append({"t": rtype, **fields})

    @staticmethod
    def _submit_record(rid: int, prompt, max_new_tokens: int,
                       eos_token_id, deadline, primed=None,
                       age_s: float = 0.0, trace_id=None) -> dict:
        rec = {"t": "submit", "rid": int(rid),
               "prompt": [int(x) for x in prompt],
               "max_new_tokens": int(max_new_tokens),
               "eos_token_id": (None if eos_token_id is None
                                else int(eos_token_id)),
               "deadline": (None if deadline is None else
                            deadline.to_doc()),
               # wall clock (monotonic doesn't survive a restart): lets
               # recover() age replayed deadlines by real elapsed time.
               # Backdated by age_s so a request that already aged on a
               # dead replica keeps aging across the failover — and keeps
               # aging again through a SECOND failover.
               "submit_wall": time.time() - float(age_s)}
        if primed:
            # failover re-submission: tokens the dead replica already
            # delivered — folded as this rid's starting high-water mark so
            # THIS journal has no gap before its first deliver record
            rec["primed"] = [int(x) for x in primed]
        if trace_id is not None:
            # distributed-trace id (schema-additive: old journals simply
            # lack the key): the replay path re-mints from this, so one
            # trace survives any number of crashes and fail-overs
            rec["trace_id"] = str(trace_id)
        return rec

    def submit(self, rid: int, prompt, max_new_tokens: int,
               eos_token_id, deadline, primed=None,
               age_s: float = 0.0, trace_id=None) -> None:
        with self._lock:
            self._pending.append(self._submit_record(
                rid, prompt, max_new_tokens, eos_token_id, deadline,
                primed=primed, age_s=age_s, trace_id=trace_id))

    def submit_durable(self, rid: int, prompt, max_new_tokens: int,
                       eos_token_id, deadline, primed=None,
                       age_s: float = 0.0, trace_id=None) -> None:
        """Record an accepted request and flush it to disk as ONE atomic
        operation.  On a flush failure exactly this record is dropped
        from the buffer (other threads' pending records — e.g. the
        serving thread's deliver records awaiting a step-flush retry —
        stay put) and the error propagates: the client sees the refusal
        and no ghost request can be replayed after a crash."""
        rec = self._submit_record(rid, prompt, max_new_tokens,
                                  eos_token_id, deadline,
                                  primed=primed, age_s=age_s,
                                  trace_id=trace_id)
        with self._lock:
            self._pending.append(rec)
            try:
                self._flush_locked()
            except BaseException:
                if rec in self._pending:
                    self._pending.remove(rec)
                raise

    def deliver(self, rid: int, idx: int, token: int) -> None:
        self.record("deliver", rid=int(rid), idx=int(idx), tok=int(token))

    def finish(self, rid: int) -> None:
        self.record("finish", rid=int(rid))

    def shed(self, rid: int, reason: str) -> None:
        self.record("shed", rid=int(rid), reason=str(reason))

    def flush(self) -> Optional[str]:
        """Write buffered records as one atomic segment (no-op when
        empty).  Raises ``OSError`` when storage stays down past the retry
        budget — the engine's step loop counts that as a step failure and
        retries with the records still buffered."""
        with self._lock:
            return self._flush_locked()

    def _flush_locked(self) -> Optional[str]:
        if not self._pending:
            return None
        path = os.path.join(self.root, _SEG_FMT.format(self._next_seg))
        data = json.dumps(self._pending).encode()
        write_bytes(path, data, op="serve_journal")
        if self._ship is not None:
            try:
                self._ship(self._next_seg, data)
            except BaseException:
                # depot refused (outage OR fence): remove the local
                # segment so disk and depot agree the flush never
                # happened — otherwise a crash before the retry would
                # fold a record the client was told was refused (ghost
                # submit) or one the depot can't replay.  Records stay
                # pending; submit_durable additionally unwinds its own.
                try:
                    os.remove(path)
                except OSError:
                    pass
                raise
        # buffered records are durable only now; a flush failure above
        # leaves them pending for the next attempt
        self._pending.clear()
        self._next_seg += 1
        return path

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._pending)

    # -- reading -----------------------------------------------------------
    def segments(self) -> List[str]:
        try:
            names = sorted(n for n in os.listdir(self.root)
                           if n.startswith("seg_") and n.endswith(".json"))
        except FileNotFoundError:
            return []
        return [os.path.join(self.root, n) for n in names]

    def load_state(self) -> JournalState:
        segs = self.segments()
        st = JournalState()
        for i, path in enumerate(segs):
            try:
                records = json.loads(read_bytes(path, op="serve_journal"))
            except (ValueError, OSError):
                # torn segment (injected truncate / storage outage): stop
                # at the previous boundary — an EARLIER high-water mark is
                # safe (sink dedups, regeneration is deterministic), a
                # partially-applied later one is not.  QUARANTINE the
                # corrupt segment and everything after it (their records
                # are discarded from the logical log): left in place they
                # would shadow every segment this incarnation writes
                # next, and the SECOND crash would lose all work accepted
                # after the first recovery.
                st.truncated = True
                for later in segs[i:]:
                    try:
                        os.replace(later, later + ".quarantined")
                    except OSError:
                        pass
                break
            for rec in records:
                self._fold(st, rec)
            st.segments_read += 1
        return st

    @staticmethod
    def _fold(st: JournalState, rec: dict) -> None:
        t, rid = rec.get("t"), rec.get("rid")
        if t == "submit":
            st.requests[rid] = rec
            toks = st.delivered.setdefault(rid, [])
            primed = rec.get("primed") or []
            if len(primed) > len(toks):
                # failover re-submission: the dead replica's delivered
                # high-water mark is this incarnation's starting point
                st.delivered[rid] = [int(x) for x in primed]
        elif t == "deliver":
            toks = st.delivered.setdefault(rid, [])
            idx = rec["idx"]
            if idx == len(toks):
                toks.append(rec["tok"])
            elif idx < len(toks):
                # duplicate record (re-flushed after a partial failure):
                # determinism means it must agree
                if toks[idx] != rec["tok"]:
                    raise ValueError(
                        f"journal deliver mismatch for rid {rid} idx {idx}: "
                        f"{toks[idx]} vs {rec['tok']}")
            else:
                raise ValueError(
                    f"journal gap for rid {rid}: deliver idx {idx} after "
                    f"{len(toks)} tokens")
        elif t == "finish":
            st.finished.add(rid)
        elif t == "shed":
            st.shed[rid] = rec.get("reason", "unknown")


class TokenSink:
    """Exactly-once client delivery channel backed by an append-only JSONL
    file.  ``sink(rid, idx, token)`` appends one line per NEW token;
    re-emissions at or below the per-request high-water mark (recovery
    replays, eviction replays) are dropped.  On construction the sink
    reads its own file back, so the guarantee spans process restarts."""

    def __init__(self, path: str):
        self.path = str(path)
        self._counts: Dict[int, int] = {}
        self.dropped = 0
        for rid, idx, _ in self.read(self.path):
            if idx == self._counts.get(rid, 0):
                self._counts[rid] = idx + 1
        self._f = open(self.path, "a")

    def __call__(self, rid: int, idx: int, token: int) -> None:
        count = self._counts.get(rid, 0)
        if idx < count:
            self.dropped += 1      # already delivered (dedup)
            return
        if idx > count:
            raise ValueError(f"token gap for rid {rid}: emit idx {idx} "
                             f"after {count} delivered")
        self._f.write(json.dumps({"rid": int(rid), "idx": int(idx),
                                  "tok": int(token)}) + "\n")
        self._f.flush()
        self._counts[rid] = count + 1

    def delivered(self, rid: int) -> int:
        return self._counts.get(int(rid), 0)

    def close(self) -> None:
        self._f.close()

    @staticmethod
    def read(path: str) -> List[tuple]:
        """Parse a sink file into ``(rid, idx, token)`` tuples, skipping a
        torn final line."""
        out = []
        try:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        doc = json.loads(line)
                        out.append((doc["rid"], doc["idx"], doc["tok"]))
                    except (ValueError, KeyError):
                        continue
        except FileNotFoundError:
            pass
        return out

    @classmethod
    def collect(cls, path: str) -> Dict[int, List[int]]:
        """Per-request delivered token streams; raises on duplicate or
        out-of-order indices (the exactly-once assertion a test wants)."""
        streams: Dict[int, List[int]] = {}
        for rid, idx, tok in cls.read(path):
            toks = streams.setdefault(rid, [])
            if idx != len(toks):
                raise AssertionError(
                    f"sink violates exactly-once for rid {rid}: got idx "
                    f"{idx}, expected {len(toks)}")
            toks.append(tok)
        return streams
