"""Snapshot replication transport: the peer-RAM half of in-memory recovery.

:mod:`.snapshot` captures each rank's shards into host RAM; this module
moves the CRC-tagged copies somewhere that survives the rank's death, so a
gang restart can resume from the last snapshot *generation* instead of the
last disk checkpoint (Gemini SOSP'23 / MegaScale NSDI'24 recovery model:
RPO = snapshot period in steps, not checkpoint interval).

Two transports behind one duck-typed surface (``put`` / ``fetch`` /
``complete_generations`` / ``max_step`` / ``drop_holder`` /
``report_resume`` / ``resume_reports``):

- :class:`SnapshotStore` + :class:`SnapshotClient` — a tiny TCP daemon
  (framed JSON header + raw payload bytes, so multi-MB shard blobs never
  ride base64) hosted by the *launcher* process (``launch.main`` /
  ``FleetSupervisor``).  The launcher is the stand-in for the per-host
  memory agent of the reference designs: worker processes die and relaunch
  around it, so copies survive a SIGKILL'd rank.  Each copy is tagged with
  the rank whose *host RAM conceptually holds it* (``holder``): rank ``r``
  ships its snapshot twice — ``holder=r`` (its own host RAM) and
  ``holder=(r+1) % world`` (the ring-neighbor peer replica).  An
  UNCOORDINATED rank death (SIGKILL, non-101 exit — a lost host, not a
  poison-poll exit) makes the launcher call :meth:`drop_holder`, which
  deletes every copy that rank held: the dead rank's own copy AND the
  replica it kept for its ring predecessor.  Recovery then walks holder
  preference (own copy → peer replica) per rank, and a generation is only
  *complete* when every rank still has at least one valid copy at the
  same step — a torn generation (some ranks snapped step N, some N−10)
  is never offered.
- :class:`KVTransport` — the same protocol over any ``TCPStore``-shaped
  client or put/get KV (``FileStore``, ``TCPKVStore``), payloads base64 in
  JSON values.  The fallback when no snapshot daemon is addressable, and
  the transport of chaos children that load this module standalone.

This module is deliberately **stdlib-only and standalone-loadable**
(importlib, no package import, no numpy) — payload bytes are opaque
here; serialization lives in :mod:`.snapshot`.

Env contract: ``PADDLE_TPU_SNAP_STORE`` (host:port of the snapshot daemon,
exported by the launcher), ``PADDLE_TPU_SNAP_TIMEOUT`` (client I/O
deadline, default 30s).
"""

from __future__ import annotations

import base64
import json
import os
import socket
import struct
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

# the client's reconnect-once loop routes through the shared backoff/retry
# engine when the package context is available; a standalone importlib
# load (standalone chaos children) falls back to the inline equivalent so
# this file stays stdlib-only loadable
try:
    from ..retry import retry_call as _retry_call
except (ImportError, SystemError, ValueError):
    _retry_call = None

__all__ = [
    "SnapshotStore", "SnapshotClient", "KVTransport", "FencedEpoch",
    "ensure_host_store", "transport_from_env", "crc32", "env_int",
]

_HDR = struct.Struct(">I")
_KEEP_GENS = 2  # double-buffer on the store side too
# serving-journal record family: keep the newest N fencing EPOCHS per
# replica (an epoch's segment set must stay complete — the fold needs every
# segment from the incarnation's start — so retention prunes whole epochs,
# never individual segments)
_KEEP_JOURNAL_EPOCHS = 2


class FencedEpoch(OSError):
    """A journal put was refused because the replica's epoch is fenced:
    the frontend declared this incarnation dead and bumped the fence, so a
    zombie's late flush must change nothing.  An ``OSError`` on purpose —
    the serving step loop absorbs it like a storage failure, which blocks
    the zombie's token emission (flush gates the sink) without crashing
    the depot connection."""


def crc32(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


def env_int(name: str, default: int) -> int:
    """Int env knob with a safe fallback (shared by the snapshot stack —
    this module is the one stdlib-only home both sides can import)."""
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def _snap_timeout() -> float:
    try:
        return float(os.environ.get("PADDLE_TPU_SNAP_TIMEOUT", 30.0))
    except (TypeError, ValueError):
        return 30.0


# -- framing -----------------------------------------------------------------
# one message = 4-byte length + JSON header; when the header carries
# ``nbytes > 0`` that many raw payload bytes follow immediately.  Raw bytes
# (not base64) because snapshots are the largest thing this repo ships over
# a socket.

def _send(sock: socket.socket, head: dict, payload: bytes = b"") -> None:
    head = dict(head, nbytes=len(payload))
    data = json.dumps(head).encode()
    sock.sendall(_HDR.pack(len(data)) + data + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise ConnectionError("snapshot store connection closed")
        buf += chunk
    return buf


def _recv(sock: socket.socket) -> Tuple[dict, bytes]:
    (n,) = _HDR.unpack(_recv_exact(sock, _HDR.size))
    head = json.loads(_recv_exact(sock, n))
    payload = _recv_exact(sock, head.get("nbytes", 0)) \
        if head.get("nbytes") else b""
    return head, payload


# chaos seam for the ``net`` fault family: resolved lazily and cached so
# this module stays stdlib-only loadable standalone (no package context —
# then the seam is simply inert)
_FAULTS = None
_FAULTS_TRIED = False


def _fire_net(op: str, addr: str) -> None:
    global _FAULTS, _FAULTS_TRIED
    if not _FAULTS_TRIED:
        _FAULTS_TRIED = True
        try:
            from . import faults as _mod
            _FAULTS = _mod
        except ImportError:
            _FAULTS = None
    if _FAULTS is not None:
        _FAULTS.fire(op, addr)


# -- the launcher-hosted daemon ----------------------------------------------

class SnapshotStore(threading.Thread):
    """In-memory snapshot depot: accept loop + per-connection handlers over
    a locked copy table ``{(src, holder, gen): meta+payload}``.

    Retention: per ``(src, holder)`` only the newest ``_KEEP_GENS``
    generations are kept (the shipping side is double-buffered; keeping two
    means a crash mid-generation never strands recovery on a torn one).
    """

    def __init__(self, host: str = "", port: int = 0):
        super().__init__(daemon=True, name="paddle-tpu-snapstore")
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        # wildcard bind by default (like the TCPStore master): a multi-node
        # gang's depot must be reachable from every pod, not just loopback
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.host = host
        self.port = self._sock.getsockname()[1]
        self._lock = threading.Lock()
        # (src, holder, gen) -> {"step","crc","ts","payload"}
        self._copies: Dict[Tuple[int, int, int], Dict[str, Any]] = {}
        self._reports: Dict[int, Dict[int, dict]] = {}
        # serving-journal record family (keyed by replica NAME, not rank):
        # (replica, epoch, seq) -> {"crc","ts","payload"}; _fence maps
        # replica -> minimum epoch the depot still accepts puts for
        self._journal: Dict[Tuple[str, int, int], Dict[str, Any]] = {}
        self._fence: Dict[str, int] = {}
        # telemetry snapshots: src name -> latest pushed metrics doc
        # (last-write-wins; the launcher's rollup pulls the whole map)
        self._metrics: Dict[str, Dict[str, Any]] = {}
        # disaggregated-serving KV streams: a prefill worker
        # streams one finished prompt's KV pages as framed puts keyed
        # (replica, epoch, rid, frame_idx), then COMMITS a meta doc keyed
        # (replica, epoch, rid).  The commit is the visibility AND the
        # exactly-once gate: uncommitted frames can never be taken (a
        # worker dying mid-stream leaves nothing claimable), and kv_take
        # flips a one-shot "taken" flag so two decode workers can never
        # both import the same rid.  Puts/commits honor _fence like the
        # journal does — same namespace, so one fence call kills a dead
        # incarnation's journal flushes AND its in-flight KV streams.
        self._kv_frames: Dict[Tuple[str, int, int, int],
                              Dict[str, Any]] = {}
        self._kv_meta: Dict[Tuple[str, int, int], Dict[str, Any]] = {}
        self._stop = threading.Event()
        self.start()

    @property
    def address(self) -> str:
        """Locally-dialable address (loopback for wildcard binds; a
        multi-node launcher advertises its real hostname instead)."""
        host = self.host if self.host not in ("", "0.0.0.0") else "127.0.0.1"
        return f"{host}:{self.port}"

    @property
    def alive(self) -> bool:
        return not self._stop.is_set()

    # -- server loop -------------------------------------------------------
    def run(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def close(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass

    def _serve(self, conn: socket.socket) -> None:
        try:
            while True:
                head, payload = _recv(conn)
                try:
                    resp, out = getattr(self, "_cmd_" + head["cmd"])(
                        head, payload)
                except Exception as e:  # a bad request must not kill the depot
                    resp, out = {"error": f"{type(e).__name__}: {e}"}, b""
                _send(conn, resp, out)
        except (ConnectionError, OSError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    # -- commands ----------------------------------------------------------
    def _cmd_put(self, head, payload):
        src, gen = int(head["src"]), int(head["gen"])
        holders = [int(h) for h in head["holders"]] \
            if "holders" in head else [int(head["holder"])]
        want = int(head["crc"])
        if crc32(payload) != want:
            return {"ok": False, "error": "crc mismatch on ingest"}, b""
        with self._lock:
            for holder in holders:
                # one payload object shared across holder slots: replicas
                # cost table entries, not copies of a multi-MB blob
                self._copies[(src, holder, gen)] = {
                    "step": int(head["step"]), "crc": want,
                    "ts": time.time(), "payload": payload}
                gens = sorted(g for (s, h, g) in self._copies
                              if s == src and h == holder)
                for g in gens[:-_KEEP_GENS]:
                    self._copies.pop((src, holder, g), None)
        return {"ok": True}, b""

    def _cmd_fetch(self, head, payload):
        src = int(head["src"])
        gen = head.get("gen")
        exclude = {int(h) for h in head.get("exclude_holders") or ()}
        with self._lock:
            cands = [(h, g, doc) for (s, h, g), doc in self._copies.items()
                     if s == src and doc["payload"] is not None
                     and h not in exclude
                     and (gen is None or g == int(gen))]
            if not cands:
                return {"found": False}, b""
            # newest generation; within it prefer the rank's OWN copy
            # (holder == src → resume_source "memory") over a peer replica
            best = max(cands, key=lambda c: (c[1], c[0] == src))
            h, g, doc = best
            return ({"found": True, "holder": h, "gen": g,
                     "step": doc["step"], "crc": doc["crc"]},
                    doc["payload"])

    def _cmd_complete(self, head, payload):
        world = int(head["world"])
        with self._lock:
            by_gen: Dict[int, Dict[int, int]] = {}
            for (s, h, g), doc in self._copies.items():
                if doc["payload"] is None:
                    continue  # tombstone: the copy's host was lost
                by_gen.setdefault(g, {})[s] = doc["step"]
            out = []
            for g in sorted(by_gen, reverse=True):
                ranks = by_gen[g]
                if set(ranks) >= set(range(world)) and \
                        len(set(ranks.values())) == 1:
                    out.append({"gen": g, "step": ranks[0]})
        return {"generations": out}, b""

    def _cmd_max_step(self, head, payload):
        with self._lock:
            steps = [d["step"] for d in self._copies.values()]
        return {"step": max(steps) if steps else None}, b""

    def _cmd_drop_holder(self, head, payload):
        """Host loss: the copies rank ``rank`` held are gone — but leave
        TOMBSTONES (meta without payload) so recovery still knows how far
        training had progressed (honest ``steps_lost``) and that snapshots
        existed-but-were-unusable (the ``snapshot_unrecoverable``
        breadcrumb), even when every copy is lost."""
        rank = int(head["rank"])
        dropped = 0
        with self._lock:
            for (s, h, g), doc in self._copies.items():
                if h == rank and doc["payload"] is not None:
                    doc["payload"] = None
                    dropped += 1
        return {"dropped": dropped}, b""

    def _cmd_report_resume(self, head, payload):
        epoch = int(head.get("epoch", 0))
        with self._lock:
            self._reports.setdefault(epoch, {})[int(head["rank"])] = {
                "source": head.get("source"), "step": head.get("step"),
                "steps_lost": head.get("steps_lost")}
        return {"ok": True}, b""

    def _cmd_resume_reports(self, head, payload):
        epoch = int(head.get("epoch", 0))
        with self._lock:
            return {"reports": {str(r): dict(d) for r, d in
                                self._reports.get(epoch, {}).items()}}, b""

    def _cmd_index(self, head, payload):
        with self._lock:
            return {"copies": [
                {"src": s, "holder": h, "gen": g, "step": d["step"],
                 "crc": d["crc"],
                 "nbytes": (len(d["payload"])
                            if d["payload"] is not None else None),
                 "dropped": d["payload"] is None}
                for (s, h, g), d in sorted(self._copies.items())]}, b""

    # -- serving-journal record family ------------------------------------
    # A serving replica ships every journal segment here at the same flush
    # boundary that gates token emission, so the depot's view of a
    # replica's ledger is always >= what any client was shown.  Fencing:
    # when the frontend declares a replica incarnation dead it bumps the
    # replica's fence epoch; a zombie still flushing at the old epoch is
    # refused (``fenced`` refusal, not an ``error`` — the client raises
    # :class:`FencedEpoch` so callers can tell it from an outage).

    def _cmd_journal_put(self, head, payload):
        replica, epoch = str(head["replica"]), int(head["epoch"])
        seq, want = int(head["seq"]), int(head["crc"])
        if crc32(payload) != want:
            return {"ok": False, "reason": "crc mismatch on ingest"}, b""
        with self._lock:
            fence = self._fence.get(replica, 0)
            if epoch < fence:
                return {"ok": False, "fenced": True,
                        "fence_epoch": fence}, b""
            self._journal[(replica, epoch, seq)] = {
                "crc": want, "ts": time.time(), "payload": payload}
            # retention prunes whole STALE EPOCHS (never individual
            # segments — a fold needs the epoch's full segment set)
            epochs = sorted({e for (r, e, _s) in self._journal
                             if r == replica})
            for e in epochs[:-_KEEP_JOURNAL_EPOCHS]:
                for key in [k for k in self._journal
                            if k[0] == replica and k[1] == e]:
                    self._journal.pop(key, None)
        return {"ok": True}, b""

    def _cmd_journal_index(self, head, payload):
        replica = str(head["replica"])
        epoch = head.get("epoch")
        with self._lock:
            segs = [{"epoch": e, "seq": s, "crc": d["crc"],
                     "nbytes": len(d["payload"])}
                    for (r, e, s), d in sorted(self._journal.items())
                    if r == replica and (epoch is None or e == int(epoch))]
            return {"segments": segs,
                    "fence_epoch": self._fence.get(replica, 0)}, b""

    def _cmd_journal_get(self, head, payload):
        key = (str(head["replica"]), int(head["epoch"]), int(head["seq"]))
        with self._lock:
            doc = self._journal.get(key)
            if doc is None:
                return {"found": False}, b""
            return {"found": True, "crc": doc["crc"]}, doc["payload"]

    def _cmd_journal_replicas(self, head, payload):
        with self._lock:
            names = sorted({r for (r, _e, _s) in self._journal}
                           | set(self._fence))
        return {"replicas": names}, b""

    def _cmd_fence(self, head, payload):
        replica, epoch = str(head["replica"]), int(head["epoch"])
        with self._lock:
            # monotonic max: concurrent fencers (frontend restart racing
            # the original scan) can only tighten the fence, never reopen
            # a dead incarnation's rid-space
            cur = max(self._fence.get(replica, 0), epoch)
            self._fence[replica] = cur
        return {"fence_epoch": cur}, b""

    def _cmd_fence_epoch(self, head, payload):
        with self._lock:
            return {"fence_epoch":
                    self._fence.get(str(head["replica"]), 0)}, b""

    # -- disaggregated-serving KV streams -----------------------

    def _cmd_kv_put(self, head, payload):
        replica, epoch = str(head["replica"]), int(head["epoch"])
        rid, idx, want = int(head["rid"]), int(head["idx"]), int(head["crc"])
        if crc32(payload) != want:
            return {"ok": False, "reason": "crc mismatch on ingest"}, b""
        with self._lock:
            fence = self._fence.get(replica, 0)
            if epoch < fence:
                return {"ok": False, "fenced": True,
                        "fence_epoch": fence}, b""
            self._kv_frames[(replica, epoch, rid, idx)] = {
                "crc": want, "ts": time.time(), "payload": payload}
            # retention mirrors the journal: whole STALE EPOCHS per
            # replica (a partial frame set is useless — import needs
            # every frame of a committed rid)
            epochs = sorted({e for (r, e, _rid, _i) in self._kv_frames
                             if r == replica})
            for e in epochs[:-_KEEP_JOURNAL_EPOCHS]:
                for key in [k for k in self._kv_frames
                            if k[0] == replica and k[1] == e]:
                    self._kv_frames.pop(key, None)
                for key in [k for k in self._kv_meta
                            if k[0] == replica and k[1] == e]:
                    self._kv_meta.pop(key, None)
        return {"ok": True}, b""

    def _cmd_kv_commit(self, head, payload):
        replica, epoch = str(head["replica"]), int(head["epoch"])
        rid = int(head["rid"])
        meta = json.loads(payload) if payload else {}
        n = int(meta.get("n_frames", 0))
        with self._lock:
            fence = self._fence.get(replica, 0)
            if epoch < fence:
                return {"ok": False, "fenced": True,
                        "fence_epoch": fence}, b""
            missing = [i for i in range(n)
                       if (replica, epoch, rid, i) not in self._kv_frames]
            if n < 1 or missing:
                return {"ok": False,
                        "reason": f"missing frames {missing or 'all'}"}, b""
            self._kv_meta[(replica, epoch, rid)] = {
                "meta": meta, "taken": False, "ts": time.time()}
        return {"ok": True}, b""

    def _cmd_kv_take(self, head, payload):
        """One-shot claim of a committed rid: first taker wins, every
        later take refuses — the decode-side half of exactly-once."""
        key = (str(head["replica"]), int(head["epoch"]), int(head["rid"]))
        with self._lock:
            doc = self._kv_meta.get(key)
            if doc is None:
                return {"found": False}, b""
            if doc["taken"]:
                return {"found": True, "taken": True}, b""
            doc["taken"] = True
            return ({"found": True, "taken": False},
                    json.dumps(doc["meta"]).encode())

    def _cmd_kv_get(self, head, payload):
        key = (str(head["replica"]), int(head["epoch"]), int(head["rid"]),
               int(head["idx"]))
        with self._lock:
            doc = self._kv_frames.get(key)
            if doc is None:
                return {"found": False}, b""
            return {"found": True, "crc": doc["crc"]}, doc["payload"]

    def _cmd_kv_index(self, head, payload):
        replica = str(head["replica"])
        epoch = head.get("epoch")
        with self._lock:
            rids = [{"epoch": e, "rid": rid, "taken": d["taken"],
                     "n_frames": int(d["meta"].get("n_frames", 0))}
                    for (r, e, rid), d in sorted(self._kv_meta.items())
                    if r == replica and (epoch is None or e == int(epoch))]
            return {"rids": rids,
                    "fence_epoch": self._fence.get(replica, 0)}, b""

    def _cmd_metrics_push(self, head, payload):
        doc = json.loads(payload) if payload else {}
        with self._lock:
            self._metrics[str(head["src"])] = doc
        return {"ok": True}, b""

    def _cmd_metrics_pull(self, head, payload):
        with self._lock:
            docs = dict(self._metrics)
        return {"ok": True}, json.dumps(docs).encode()


class SnapshotClient:
    """Rank-side client of :class:`SnapshotStore` (one socket, lock-
    serialized calls).  Transport failures surface as ``OSError`` — the
    snapshotter counts them and training continues at degraded RPO."""

    def __init__(self, host: str, port: int,
                 timeout: Optional[float] = None):
        self.host, self.port = host, int(port)
        self.timeout = _snap_timeout() if timeout is None else float(timeout)
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None

    @classmethod
    def from_address(cls, addr: str, **kw) -> "SnapshotClient":
        host, port = addr.rsplit(":", 1)
        return cls(host, int(port), **kw)

    def _conn(self) -> socket.socket:
        if self._sock is None:
            _fire_net("net_connect", f"{self.host}:{self.port}")
            self._sock = socket.create_connection(
                (self.host, self.port), timeout=self.timeout)
            self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return self._sock

    def _exchange(self, head: dict, payload: bytes) -> Tuple[dict, bytes]:
        addr = f"{self.host}:{self.port}"
        sock = self._conn()
        _fire_net("net_write", addr)
        _send(sock, head, payload)
        _fire_net("net_read", addr)
        return _recv(sock)

    def _call(self, head: dict, payload: bytes = b"") -> Tuple[dict, bytes]:
        def _once() -> Tuple[dict, bytes]:
            return self._exchange(head, payload)

        def _reconnect(attempt: int, exc: BaseException, _d: float) -> None:
            # one transparent reconnect: every command here is
            # idempotent (put overwrites the same (src,holder,gen) cell)
            self.close()

        with self._lock:
            if _retry_call is not None:
                resp, out = _retry_call(
                    _once, attempts=2, retry_on=(OSError, ConnectionError),
                    on_retry=_reconnect)
            else:  # standalone load: same reconnect-once semantics inline
                try:
                    resp, out = _once()
                except (OSError, ConnectionError):
                    self.close()
                    resp, out = _once()
        if "error" in resp:
            raise OSError(f"snapshot store error: {resp['error']}")
        return resp, out

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    # -- transport surface -------------------------------------------------
    def put(self, src: int, holder: int, gen: int, step: int,
            payload: bytes, crc: Optional[int] = None) -> None:
        self._call({"cmd": "put", "src": src, "holder": holder, "gen": gen,
                    "step": step,
                    "crc": crc32(payload) if crc is None else crc}, payload)

    def put_replicated(self, src: int, holders: List[int], gen: int,
                       step: int, payload: bytes,
                       crc: Optional[int] = None) -> None:
        """One wire transfer for all holder slots (own + peer replica) —
        the depot shares the payload across slots, so replication costs
        half the socket bytes of two puts."""
        self._call({"cmd": "put", "src": src, "holders": list(holders),
                    "gen": gen, "step": step,
                    "crc": crc32(payload) if crc is None else crc}, payload)

    def fetch(self, src: int, gen: Optional[int] = None
              ) -> Optional[Tuple[dict, bytes]]:
        # a copy torn in flight (or corrupted at rest) is excluded and the
        # NEXT holder tried — parity with KVTransport.fetch's candidate
        # walk; bounded by the number of holders
        bad: List[int] = []
        while True:
            resp, payload = self._call({"cmd": "fetch", "src": src,
                                        "gen": gen,
                                        "exclude_holders": bad})
            if not resp.get("found"):
                return None
            if crc32(payload) == resp["crc"]:
                return resp, payload
            bad.append(int(resp["holder"]))

    def complete_generations(self, world: int) -> List[dict]:
        """Complete generations, freshest first: every rank has at least
        one valid copy and all ranks' copies stamp the SAME step."""
        resp, _ = self._call({"cmd": "complete", "world": world})
        return resp.get("generations", [])

    def max_step(self) -> Optional[int]:
        resp, _ = self._call({"cmd": "max_step"})
        return resp.get("step")

    def drop_holder(self, rank: int) -> int:
        resp, _ = self._call({"cmd": "drop_holder", "rank": rank})
        return int(resp.get("dropped", 0))

    def report_resume(self, rank: int, epoch: int, source: str,
                      step: Optional[int],
                      steps_lost: Optional[int]) -> None:
        self._call({"cmd": "report_resume", "rank": rank, "epoch": epoch,
                    "source": source, "step": step,
                    "steps_lost": steps_lost})

    def resume_reports(self, epoch: int) -> Dict[int, dict]:
        resp, _ = self._call({"cmd": "resume_reports", "epoch": epoch})
        return {int(r): d for r, d in resp.get("reports", {}).items()}

    def index(self) -> List[dict]:
        resp, _ = self._call({"cmd": "index"})
        return resp.get("copies", [])

    # -- serving-journal surface -------------------------------------------
    def journal_put(self, replica: str, epoch: int, seq: int,
                    payload: bytes, crc: Optional[int] = None) -> None:
        """Ship one journal segment.  Raises :class:`FencedEpoch` when the
        incarnation is fenced (the caller is a zombie and must NOT treat
        this as a retryable outage) and plain ``OSError`` on transport or
        ingest-CRC failure (retryable — records stay buffered)."""
        resp, _ = self._call({
            "cmd": "journal_put", "replica": str(replica),
            "epoch": int(epoch), "seq": int(seq),
            "crc": crc32(payload) if crc is None else crc}, payload)
        if not resp.get("ok"):
            if resp.get("fenced"):
                raise FencedEpoch(
                    f"journal put refused: replica {replica} epoch {epoch} "
                    f"fenced at {resp.get('fence_epoch')}")
            raise OSError(f"journal put refused: "
                          f"{resp.get('reason', 'unknown')}")

    def journal_index(self, replica: str,
                      epoch: Optional[int] = None) -> dict:
        resp, _ = self._call({"cmd": "journal_index",
                              "replica": str(replica), "epoch": epoch})
        return {"segments": resp.get("segments", []),
                "fence_epoch": int(resp.get("fence_epoch", 0))}

    def journal_fetch(self, replica: str, epoch: int
                      ) -> List[Tuple[int, bytes]]:
        """All segments of one incarnation, CRC-verified, in seq order."""
        out: List[Tuple[int, bytes]] = []
        for seg in self.journal_index(replica, epoch=epoch)["segments"]:
            resp, payload = self._call({
                "cmd": "journal_get", "replica": str(replica),
                "epoch": int(epoch), "seq": int(seg["seq"])})
            if not resp.get("found") or crc32(payload) != resp["crc"]:
                continue  # pruned or corrupt in flight: skip, fold dedups
            out.append((int(seg["seq"]), payload))
        return out

    def journal_replicas(self) -> List[str]:
        resp, _ = self._call({"cmd": "journal_replicas"})
        return list(resp.get("replicas", []))

    def fence(self, replica: str, epoch: int) -> int:
        """Raise the replica's fence to at least ``epoch`` (monotonic) and
        return the resulting fence epoch.  ``fence(name, 0)`` is the
        read-adopt idiom a fresh incarnation uses at startup."""
        resp, _ = self._call({"cmd": "fence", "replica": str(replica),
                              "epoch": int(epoch)})
        return int(resp["fence_epoch"])

    def fence_epoch(self, replica: str) -> int:
        resp, _ = self._call({"cmd": "fence_epoch",
                              "replica": str(replica)})
        return int(resp.get("fence_epoch", 0))

    # -- disaggregated-serving KV streams -----------------------
    def kv_put(self, replica: str, epoch: int, rid: int, idx: int,
               payload: bytes) -> None:
        """Stream one KV-page frame.  Raises :class:`FencedEpoch` when the
        incarnation is fenced (the prefill worker is a zombie — its
        half-streamed rid must never become claimable) and plain
        ``OSError`` on transport/ingest-CRC failure (retryable)."""
        resp, _ = self._call({
            "cmd": "kv_put", "replica": str(replica), "epoch": int(epoch),
            "rid": int(rid), "idx": int(idx),
            "crc": crc32(payload)}, payload)
        if not resp.get("ok"):
            if resp.get("fenced"):
                raise FencedEpoch(
                    f"kv put refused: replica {replica} epoch {epoch} "
                    f"fenced at {resp.get('fence_epoch')}")
            raise OSError(f"kv put refused: "
                          f"{resp.get('reason', 'unknown')}")

    def kv_commit(self, replica: str, epoch: int, rid: int,
                  meta: dict) -> None:
        """Commit a fully-streamed rid (the exactly-once visibility gate:
        nothing before this call is claimable).  The depot verifies every
        frame ``0..n_frames-1`` arrived; raises :class:`FencedEpoch` /
        ``OSError`` like :meth:`kv_put`."""
        resp, _ = self._call({
            "cmd": "kv_commit", "replica": str(replica),
            "epoch": int(epoch), "rid": int(rid)},
            json.dumps(meta, default=repr).encode())
        if not resp.get("ok"):
            if resp.get("fenced"):
                raise FencedEpoch(
                    f"kv commit refused: replica {replica} epoch {epoch} "
                    f"fenced at {resp.get('fence_epoch')}")
            raise OSError(f"kv commit refused: "
                          f"{resp.get('reason', 'unknown')}")

    def kv_take(self, replica: str, epoch: int, rid: int) -> Optional[dict]:
        """Claim a committed rid exactly once: returns its meta doc for
        the FIRST caller, ``None`` for everyone else (already taken, or
        never committed)."""
        resp, payload = self._call({"cmd": "kv_take",
                                    "replica": str(replica),
                                    "epoch": int(epoch), "rid": int(rid)})
        if not resp.get("found") or resp.get("taken"):
            return None
        return json.loads(payload) if payload else {}

    def kv_get(self, replica: str, epoch: int, rid: int,
               idx: int) -> Optional[bytes]:
        """One frame, CRC-verified; ``None`` when pruned/corrupt."""
        resp, payload = self._call({
            "cmd": "kv_get", "replica": str(replica), "epoch": int(epoch),
            "rid": int(rid), "idx": int(idx)})
        if not resp.get("found") or crc32(payload) != resp.get("crc"):
            return None
        return payload

    def kv_index(self, replica: str, epoch: Optional[int] = None) -> dict:
        """Committed rids of a replica (optionally one epoch) with their
        taken flags, plus the current fence epoch — the fold/replay scan."""
        resp, _ = self._call({"cmd": "kv_index", "replica": str(replica),
                              "epoch": epoch})
        return {"rids": resp.get("rids", []),
                "fence_epoch": int(resp.get("fence_epoch", 0))}

    # -- telemetry snapshots (the fleet observability plane) ---------------
    def metrics_push(self, src: str, doc: dict) -> None:
        """Publish one process's latest metrics snapshot (last-write-wins
        per ``src``); the launcher's rollup pulls the whole map."""
        self._call({"cmd": "metrics_push", "src": str(src)},
                   json.dumps(doc, default=repr).encode())

    def metrics_pull(self) -> Dict[str, dict]:
        _resp, payload = self._call({"cmd": "metrics_pull"})
        return json.loads(payload) if payload else {}


# -- KV fallback transport ---------------------------------------------------

def _kv_is_raw(kv) -> bool:
    """TCPStore-shaped (set/get/keys/delete_key) vs put/get KV
    (FileStore/TCPKVStore)."""
    return hasattr(kv, "set") and hasattr(kv, "delete_key")


class KVTransport:
    """The snapshot protocol over a plain KV store — the fallback when no
    snapshot daemon is addressable, and the path standalone chaos children
    exercise standalone.  Payload bytes ride base64 inside JSON values
    (fine at the sizes the KV path is for; the TCP daemon is the bulk
    path).  Key layout::

        <prefix>copy/<src>/<holder>/<gen>   {"crc","b64"}    (payload)
        <prefix>meta/<src>/<holder>/<gen>   {"step","crc","ts"[,"dropped"]}
        <prefix>resume/<epoch>/<rank>       {"source","step","steps_lost"}

    Metadata lives in its own small key so generation resolution
    (``complete_generations`` / ``max_step``) reads O(copies) keys, never
    the payloads; the meta write is the commit point (payload first, meta
    second — a listed copy always has its payload).
    """

    def __init__(self, kv, prefix: str = "snap/"):
        self._kv = kv
        self._raw = _kv_is_raw(kv)
        self._prefix = prefix

    # -- minimal dual-backend KV ops ---------------------------------------
    def _set(self, key: str, doc: dict) -> None:
        if self._raw:
            self._kv.set(self._prefix + key, json.dumps(doc))
        else:
            self._kv.put(self._prefix + key, doc)

    def _get(self, key: str) -> Optional[dict]:
        full = self._prefix + key
        if self._raw:
            age = self._kv.age(full)
            if age is None:
                return None
            try:
                return json.loads(self._kv.get(full, timeout=5.0))
            except (TimeoutError, ValueError):
                return None
        doc = self._kv.get(full)
        return doc if isinstance(doc, dict) else None

    def _keys(self, sub: str = "") -> List[str]:
        n = len(self._prefix)
        return [k[n:] for k in self._kv.keys(self._prefix + sub)]

    def _del(self, key: str) -> None:
        try:
            if self._raw:
                self._kv.delete_key(self._prefix + key)
            else:
                self._kv.delete(self._prefix + key)
        except Exception:
            pass

    # -- transport surface -------------------------------------------------
    def put(self, src: int, holder: int, gen: int, step: int,
            payload: bytes, crc: Optional[int] = None) -> None:
        crc = crc32(payload) if crc is None else int(crc)
        # payload first, meta second: the meta key is the commit point
        self._set(f"copy/{src}/{holder}/{gen}", {
            "crc": crc, "b64": base64.b64encode(payload).decode()})
        self._set(f"meta/{src}/{holder}/{gen}", {
            "step": int(step), "crc": crc, "ts": time.time()})
        # KV-side retention mirrors the daemon's double buffer
        gens = sorted(self._copy_gens(src, holder))
        for g in gens[:-_KEEP_GENS]:
            self._del(f"meta/{src}/{holder}/{g}")
            self._del(f"copy/{src}/{holder}/{g}")

    def put_replicated(self, src: int, holders: List[int], gen: int,
                       step: int, payload: bytes,
                       crc: Optional[int] = None) -> None:
        for holder in holders:
            self.put(src, holder, gen, step, payload, crc=crc)

    def _copy_keys(self) -> List[Tuple[int, int, int]]:
        out = []
        for k in self._keys("meta/"):
            parts = k.split("/")
            if len(parts) == 4 and parts[0] == "meta":
                try:
                    out.append((int(parts[1]), int(parts[2]), int(parts[3])))
                except ValueError:
                    continue
        return out

    def _copy_gens(self, src: int, holder: int) -> List[int]:
        return [g for (s, h, g) in self._copy_keys()
                if s == src and h == holder]

    def fetch(self, src: int, gen: Optional[int] = None
              ) -> Optional[Tuple[dict, bytes]]:
        cands = [(h, g) for (s, h, g) in self._copy_keys()
                 if s == src and (gen is None or g == gen)]
        for h, g in sorted(cands, key=lambda c: (c[1], c[0] == src),
                           reverse=True):
            meta = self._get(f"meta/{src}/{h}/{g}")
            if meta is None or meta.get("dropped"):
                continue  # missing or tombstoned (holder's host lost)
            doc = self._get(f"copy/{src}/{h}/{g}")
            if doc is None or "b64" not in doc:
                continue
            payload = base64.b64decode(doc["b64"])
            if crc32(payload) != doc["crc"]:
                continue  # corrupt at rest: walk on to the next copy
            return ({"found": True, "holder": h, "gen": g,
                     "step": meta["step"], "crc": doc["crc"]}, payload)
        return None

    def complete_generations(self, world: int) -> List[dict]:
        by_gen: Dict[int, Dict[int, int]] = {}
        for (s, h, g) in self._copy_keys():
            meta = self._get(f"meta/{s}/{h}/{g}")
            if meta is not None and not meta.get("dropped"):
                by_gen.setdefault(g, {})[s] = meta["step"]
        out = []
        for g in sorted(by_gen, reverse=True):
            ranks = by_gen[g]
            if set(ranks) >= set(range(world)) and \
                    len(set(ranks.values())) == 1:
                out.append({"gen": g, "step": next(iter(ranks.values()))})
        return out

    def max_step(self) -> Optional[int]:
        steps = [d["step"] for d in
                 (self._get(f"meta/{s}/{h}/{g}")
                  for (s, h, g) in self._copy_keys()) if d]
        return max(steps) if steps else None

    def drop_holder(self, rank: int) -> int:
        """Tombstone (keep step metadata, drop the payload) — same
        semantics as the daemon: progress stays known, data is gone."""
        dropped = 0
        for s, h, g in self._copy_keys():
            if h != rank:
                continue
            meta = self._get(f"meta/{s}/{h}/{g}")
            if meta is None or meta.get("dropped"):
                continue
            self._set(f"meta/{s}/{h}/{g}", dict(meta, dropped=True))
            self._del(f"copy/{s}/{h}/{g}")
            dropped += 1
        return dropped

    def report_resume(self, rank: int, epoch: int, source: str,
                      step: Optional[int],
                      steps_lost: Optional[int]) -> None:
        self._set(f"resume/{epoch}/{rank}", {
            "source": source, "step": step, "steps_lost": steps_lost})

    def resume_reports(self, epoch: int) -> Dict[int, dict]:
        out = {}
        for k in self._keys(f"resume/{epoch}/"):
            try:
                rank = int(k.rsplit("/", 1)[1])
            except (IndexError, ValueError):
                continue
            doc = self._get(k)
            if doc is not None:
                out[rank] = doc
        return out

    # -- telemetry snapshots (same surface as SnapshotClient) --------------
    def metrics_push(self, src: str, doc: dict) -> None:
        self._set(f"metrics/{src}",
                  json.loads(json.dumps(doc, default=repr)))

    def metrics_pull(self) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        for k in self._keys("metrics/"):
            doc = self._get(k)
            if doc is not None:
                out[k.split("/", 1)[1]] = doc
        return out


# -- process-global hosting / discovery --------------------------------------

_hosted: Optional[SnapshotStore] = None
_hosted_lock = threading.Lock()


def ensure_host_store() -> Tuple[SnapshotStore, str]:
    """The launcher-side singleton: first call creates the depot, every
    later call in the same process (``FleetSupervisor`` epochs re-entering
    ``launch.main``) returns the SAME one — that persistence across gang
    launches is exactly what makes memory recovery survive a restart."""
    global _hosted
    with _hosted_lock:
        if _hosted is None or not _hosted.alive:
            _hosted = SnapshotStore()
        return _hosted, _hosted.address


def hosted_store() -> Optional[SnapshotStore]:
    return _hosted if (_hosted is not None and _hosted.alive) else None


def transport_from_env(kv=None):
    """Resolve this process's snapshot transport from the launch env:
    ``PADDLE_TPU_SNAP_STORE`` (the daemon) wins; otherwise a provided (or
    ``PADDLE_TPU_FLEET_STORE``-addressed) KV becomes the fallback
    transport.  ``None`` when snapshots have nowhere to replicate to
    (training still keeps the in-process RAM snapshot)."""
    if os.environ.get("PADDLE_TPU_SNAP", "1") in ("0", "false"):
        return None
    addr = os.environ.get("PADDLE_TPU_SNAP_STORE")
    if addr:
        try:
            return SnapshotClient.from_address(addr)
        except (OSError, ValueError):
            return None
    if kv is not None:
        return KVTransport(kv)
    fleet = os.environ.get("PADDLE_TPU_FLEET_STORE")
    if fleet:
        # no snapshot daemon but a fleet store IS addressable: replicate
        # through it rather than silently not at all (lazy + guarded so
        # standalone loads of this module stay package-free)
        try:
            from ..store import TCPStore

            host, port = fleet.rsplit(":", 1)
            return KVTransport(TCPStore(host, int(port), is_master=False,
                                        timeout=_snap_timeout()))
        except Exception:
            return None
    return None
