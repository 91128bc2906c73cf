"""Distributed KV store + multi-node rendezvous over TCP (port of the
reference's ``distributed/store.py``, which imports only the standard
library; the port keeps its own copy and never imports the reference).

The wire protocol is the reference's, byte for byte: a 4-byte big-endian
length, then a JSON request or reply, values base64-framed.  So a client
of either package talks to a server of the other.

Parity targets:
- `paddle/phi/core/distributed/store/tcp_store.h:121` TCPStore — the
  rank-0-hosted key/value service every comm context bootstraps through
  (get/set/add/wait/compare_set + barrier);
- `python/paddle/distributed/launch/controllers/master.py:73` HTTPMaster —
  the launch-time rendezvous service that assigns node ranks and publishes
  peer lists.

Design: one daemon server thread on the master (the process that wins the
bind race on the advertised port), blocking commands (get/wait/barrier)
parked on a condition variable server-side so clients need no polling.
The store also tracks per-key mtime so a heartbeat layer can ask key ages
without a shared filesystem.

Transport resilience: a socket error mid-call reconnects, and for
idempotent commands (get/wait/set/compare_set and the reads) the
in-flight request is transparently resent ONCE — a master blip during
rendezvous no longer kills the job. Only CONNECTION failures retry; a
recv deadline against a wedged-but-listening master surfaces immediately
(retrying would double the detection latency), and add/barrier always
surface the failure rather than risk a double count."""

from __future__ import annotations

import base64
import json
import socket
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

__all__ = ["TCPStore", "TCPKVStore", "rendezvous"]

_HDR = struct.Struct(">I")


def _send_msg(sock: socket.socket, obj: dict) -> None:
    data = json.dumps(obj).encode()
    sock.sendall(_HDR.pack(len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("store connection closed")
        buf += chunk
    return buf


def _recv_msg(sock: socket.socket) -> dict:
    (n,) = _HDR.unpack(_recv_exact(sock, _HDR.size))
    return json.loads(_recv_exact(sock, n))


def _b64(v: bytes) -> str:
    return base64.b64encode(v).decode()


def _unb64(s: str) -> bytes:
    return base64.b64decode(s)


class _StoreServer(threading.Thread):
    """Accept loop + per-connection handler threads over a shared dict."""

    def __init__(self, host: str, port: int):
        super().__init__(daemon=True, name="tcpstore-server")
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.port = self._sock.getsockname()[1]
        self._data: Dict[str, Tuple[bytes, float]] = {}
        self._barriers: Dict[str, dict] = {}
        self._cond = threading.Condition()
        self._stop = threading.Event()

    def run(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def shutdown(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        with self._cond:
            self._cond.notify_all()

    # -- command handlers -------------------------------------------------
    def _serve(self, conn: socket.socket) -> None:
        try:
            while True:
                req = _recv_msg(conn)
                try:
                    resp = getattr(self, "_cmd_" + req["cmd"])(req)
                except TimeoutError as e:
                    resp = {"error": "timeout", "detail": str(e)}
                except Exception as e:  # malformed request must not kill the server
                    resp = {"error": type(e).__name__, "detail": str(e)}
                _send_msg(conn, resp)
        except (ConnectionError, OSError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _cmd_set(self, req):
        with self._cond:
            self._data[req["key"]] = (_unb64(req["value"]), time.time())
            self._cond.notify_all()
        return {}

    def _cmd_get(self, req):
        deadline = time.time() + req.get("timeout", 300.0)
        with self._cond:
            while req["key"] not in self._data:
                if not self._cond.wait(deadline - time.time()):
                    raise TimeoutError(f"get({req['key']!r})")
            return {"value": _b64(self._data[req["key"]][0])}

    def _cmd_add(self, req):
        with self._cond:
            cur = int(self._data.get(req["key"], (b"0", 0.0))[0] or b"0")
            cur += int(req["amount"])
            self._data[req["key"]] = (str(cur).encode(), time.time())
            self._cond.notify_all()
        return {"value": cur}

    def _cmd_wait(self, req):
        deadline = time.time() + req.get("timeout", 300.0)
        with self._cond:
            while any(k not in self._data for k in req["keys"]):
                if not self._cond.wait(deadline - time.time()):
                    missing = [k for k in req["keys"] if k not in self._data]
                    raise TimeoutError(f"wait({missing})")
        return {}

    def _cmd_compare_set(self, req):
        with self._cond:
            cur = self._data.get(req["key"], (None, 0.0))[0]
            expected = _unb64(req["expected"])
            if (cur is None and expected == b"") or cur == expected:
                self._data[req["key"]] = (_unb64(req["desired"]), time.time())
                self._cond.notify_all()
            cur = self._data.get(req["key"], (b"", 0.0))[0]
            return {"value": _b64(cur)}

    def _cmd_delete(self, req):
        with self._cond:
            existed = self._data.pop(req["key"], None) is not None
            self._cond.notify_all()
        return {"value": existed}

    def _cmd_num_keys(self, req):
        with self._cond:
            return {"value": len(self._data)}

    def _cmd_keys(self, req):
        with self._cond:
            return {"value": sorted(k for k in self._data
                                    if k.startswith(req.get("prefix", "")))}

    def _cmd_age(self, req):
        with self._cond:
            if req["key"] not in self._data:
                return {"value": None}
            return {"value": time.time() - self._data[req["key"]][1]}

    def _cmd_barrier(self, req):
        key, world = req["key"], int(req["world"])
        rank = req.get("rank")
        deadline = time.time() + req.get("timeout", 300.0)
        with self._cond:
            b = self._barriers.setdefault(
                key, {"arrived": 0, "gen": 0, "ranks": set()})
            gen = b["gen"]
            b["arrived"] += 1
            if rank is not None:
                b["ranks"].add(int(rank))
            if b["arrived"] >= world:
                b["arrived"] = 0
                b["gen"] += 1
                b["ranks"] = set()
                self._cond.notify_all()
            else:
                while b["gen"] == gen:
                    if not self._cond.wait(deadline - time.time()):
                        # timeout race: the releasing arrival may have bumped
                        # the generation between this waiter's wait() expiry
                        # and its lock reacquisition — decrementing then
                        # would corrupt the NEW generation's count (−1 →
                        # permanently desynced barriers). Re-check first:
                        # a bumped gen means we were released, not timed out.
                        if b["gen"] != gen:
                            break
                        b["arrived"] -= 1
                        if rank is not None:
                            b["ranks"].discard(int(rank))
                        # name the MISSING ranks, not just the count — only
                        # meaningful when every waiter registered its rank
                        if len(b["ranks"]) == b["arrived"] and \
                                (b["ranks"] or rank is not None):
                            missing = sorted(
                                set(range(world)) - b["ranks"] -
                                ({int(rank)} if rank is not None else set()))
                            raise TimeoutError(
                                f"barrier({key!r}) at "
                                f"{b['arrived'] + 1}/{world}: missing ranks "
                                f"{missing}")
                        raise TimeoutError(f"barrier({key!r}) at "
                                           f"{b['arrived'] + 1}/{world}")
        return {}


class TCPStore:
    """Client (and optionally host) of the job KV store.

    ``TCPStore(host, port, is_master=..., world_size=..., timeout=...)`` —
    the reference's constructor shape (`tcp_store.h:121`). The master
    process starts the in-process server thread; every process (master
    included) talks to it over a socket, so semantics are identical on all
    ranks. ``port=0`` with ``is_master=True`` picks a free port (read it
    back from ``.port``)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 is_master: bool = False, world_size: int = 1,
                 timeout: float = 300.0):
        self.host, self.is_master = host, is_master
        self.world_size, self.timeout = world_size, timeout
        self._server: Optional[_StoreServer] = None
        if is_master:
            bind_host = "" if host in ("", "0.0.0.0", "localhost") else host
            self._server = _StoreServer(bind_host, port)
            self._server.start()
            port = self._server.port
        self.port = port
        # the master's own client must dial the address the server actually
        # listens on: loopback only when the bind was wildcard/loopback
        self._connect_host = ("127.0.0.1"
                              if host in ("", "0.0.0.0", "localhost",
                                          "127.0.0.1") else host)
        self._lock = threading.Lock()
        self._sock = self._connect(self._connect_host, port, timeout)

    @staticmethod
    def _connect(host: str, port: int, timeout: float) -> socket.socket:
        deadline = time.time() + timeout
        while True:
            try:
                sock = socket.create_connection((host, port), timeout=timeout)
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                return sock
            except OSError:
                if time.time() > deadline:
                    raise TimeoutError(
                        f"could not reach TCPStore at {host}:{port}")
                time.sleep(0.1)

    # commands safe to transparently resend after a transport failure: the
    # reads, plus set (last-writer-wins) and compare_set (a retry after an
    # applied first attempt observes cur == desired and applies nothing).
    # add/barrier are NOT here — a replay double-counts.
    _IDEMPOTENT = frozenset({"get", "wait", "set", "compare_set",
                             "keys", "num_keys", "age"})

    def _call(self, **req) -> dict:
        # the socket's recv deadline must EXCEED the server-side command
        # window (get/wait/barrier block up to their own timeout before the
        # server replies); if it fired first the reply would stay queued and
        # desync the framed protocol for every later call
        cmd_timeout = float(req.get("timeout") or self.timeout)
        # one bounded transparent retry for idempotent commands: a master
        # blip (restart, dropped connection) mid-rendezvous reconnects and
        # resends instead of killing the job; non-idempotent commands
        # (add/barrier/delete) still fail fast after reconnecting
        attempts = 2 if req.get("cmd") in self._IDEMPOTENT else 1
        with self._lock:
            resp = None
            for attempt in range(attempts):
                try:
                    self._sock.settimeout(cmd_timeout + 10.0)
                    _send_msg(self._sock, req)
                    resp = _recv_msg(self._sock)
                    break
                except (socket.timeout, OSError) as e:
                    # connection state unknown — reconnect so later calls
                    # see a clean stream instead of a stale reply
                    # (_connect polls the address up to self.timeout, so a
                    # restarting master has that long to come back)
                    try:
                        self._sock.close()
                    except OSError:
                        pass
                    self._sock = self._connect(self._connect_host, self.port,
                                               self.timeout)
                    # retry only CONNECTION failures (the master-blip case);
                    # a recv deadline against a listening-but-wedged master
                    # (socket.timeout) would just wait the full window again
                    if isinstance(e, socket.timeout) or \
                            attempt == attempts - 1:
                        raise TimeoutError(
                            f"store call {req.get('cmd')} timed out")
        if "error" in resp:
            if resp["error"] == "timeout":
                raise TimeoutError(resp.get("detail", ""))
            raise RuntimeError(f"store error: {resp}")
        return resp

    # -- public API (reference tcp_store.h surface) -----------------------
    def set(self, key: str, value) -> None:
        if isinstance(value, str):
            value = value.encode()
        self._call(cmd="set", key=key, value=_b64(value))

    def get(self, key: str, timeout: Optional[float] = None) -> bytes:
        return _unb64(self._call(cmd="get", key=key,
                                 timeout=timeout or self.timeout)["value"])

    def add(self, key: str, amount: int = 1) -> int:
        return self._call(cmd="add", key=key, amount=amount)["value"]

    def wait(self, keys: List[str], timeout: Optional[float] = None) -> None:
        self._call(cmd="wait", keys=list(keys),
                   timeout=timeout or self.timeout)

    def compare_set(self, key: str, expected, desired) -> bytes:
        if isinstance(expected, str):
            expected = expected.encode()
        if isinstance(desired, str):
            desired = desired.encode()
        return _unb64(self._call(cmd="compare_set", key=key,
                                 expected=_b64(expected),
                                 desired=_b64(desired))["value"])

    def delete_key(self, key: str) -> bool:
        return self._call(cmd="delete", key=key)["value"]

    def num_keys(self) -> int:
        return self._call(cmd="num_keys")["value"]

    def keys(self, prefix: str = "") -> List[str]:
        return self._call(cmd="keys", prefix=prefix)["value"]

    def age(self, key: str) -> Optional[float]:
        return self._call(cmd="age", key=key)["value"]

    def barrier(self, key: str = "_barrier", world_size: Optional[int] = None,
                timeout: Optional[float] = None,
                rank: Optional[int] = None) -> None:
        """``rank`` (optional) registers the caller so a timeout names the
        MISSING ranks instead of just an arrived/world count."""
        req = {"cmd": "barrier", "key": key,
               "world": world_size or self.world_size,
               "timeout": timeout or self.timeout}
        if rank is not None:
            req["rank"] = int(rank)
        self._call(**req)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
        if self._server is not None:
            self._server.shutdown()


class TCPKVStore:
    """Key/value backend over :class:`TCPStore` with the interface of the
    reference's elastic ``FileStore`` (put/get/delete/keys/touch/age),
    needing no shared filesystem."""

    def __init__(self, store: TCPStore, prefix: str = "elastic"):
        self._store = store
        self._prefix = prefix.rstrip("/") + "/"

    def _k(self, key: str) -> str:
        return self._prefix + key

    def put(self, key: str, value) -> None:
        self._store.set(self._k(key), json.dumps(value))

    def get(self, key: str):
        try:
            return json.loads(self._store.get(self._k(key), timeout=1.0))
        except TimeoutError:
            return None

    def delete(self, key: str) -> None:
        self._store.delete_key(self._k(key))

    def keys(self, prefix: str = "") -> List[str]:
        n = len(self._prefix)
        return [k[n:] for k in self._store.keys(self._k(prefix))]

    def touch(self, key: str) -> None:
        try:
            v = self._store.get(self._k(key), timeout=1.0)
        except TimeoutError:
            v = b"null"
        self._store.set(self._k(key), v)

    def age(self, key: str) -> float:
        a = self._store.age(self._k(key))
        return float("inf") if a is None else a


def _host_is_local(host: str) -> bool:
    """True when ``host`` names this machine — only then may a process try
    to HOST the rendezvous store. A bind test alone is wrong across nodes:
    the port is free on every other machine too, so every node would elect
    itself master and rendezvous could never complete."""
    if host in ("", "0.0.0.0", "127.0.0.1", "localhost"):
        return True
    names = {socket.gethostname(), socket.getfqdn()}
    try:
        names.update(socket.gethostbyname_ex(socket.gethostname())[2])
    except OSError:
        pass
    if host in names:
        return True
    try:
        if socket.gethostbyname(host) in names | {"127.0.0.1"}:
            return True
    except OSError:
        pass
    # IP-form hosts naming one of this machine's interfaces may not appear
    # in any hostname lookup — a bind probe is authoritative (binding a
    # SPECIFIC address only succeeds locally, and port 0 avoids races)
    try:
        probe = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            probe.bind((host, 0))
            return True
        finally:
            probe.close()
    except OSError:
        return False


def rendezvous(master: str, nnodes: int, job_id: str = "default",
               node_rank: Optional[int] = None,
               timeout: float = 300.0) -> Tuple[TCPStore, int]:
    """Multi-node launch rendezvous (reference `controllers/master.py:73`):
    a process ON the master host (bind-race decides among local peers)
    hosts the store; every other node connects as a client; every node gets
    (or registers) its node rank, publishes its hostname, and all nodes
    leave through a barrier together. Returns ``(store, node_rank)``."""
    host, port_s = master.rsplit(":", 1)
    port = int(port_s)
    store = None
    if _host_is_local(host):
        try:
            store = TCPStore(host, port, is_master=True, world_size=nnodes,
                             timeout=timeout)
        except OSError:
            store = None
    if store is None:
        store = TCPStore(host, port, is_master=False, world_size=nnodes,
                         timeout=timeout)
    if node_rank is None or node_rank < 0:
        node_rank = store.add(f"{job_id}/nnodes_joined", 1) - 1
    # every rank — explicit or auto — claims its slot exactly once, so a
    # mix of preset PADDLE_NODE_RANK pods and auto-assigned pods fails fast
    # on duplicates instead of running with a corrupt world mapping
    claims = store.add(f"{job_id}/rank_claim/{node_rank}", 1)
    if claims != 1:
        raise RuntimeError(
            f"rendezvous: node rank {node_rank} claimed by {claims} pods — "
            f"set node_rank on every pod or on none")
    store.set(f"{job_id}/node/{node_rank}", socket.gethostname())
    store.barrier(f"{job_id}/rdzv", nnodes, timeout, rank=node_rank)
    return store, node_rank
