"""paddle.distributed.rpc (reference `python/paddle/distributed/rpc/rpc.py`
— brpc-backed worker-to-worker python RPC; SURVEY N23).

This package's translation (a copy of the reference package's, which uses
no array framework): every worker runs a small threaded RPC server;
workers discover each other through the job's TCPStore (the same rendezvous
medium the launcher uses, `distributed/store.py`) and exchange
length-prefixed pickled (fn, args, kwargs) calls over raw sockets —
matching the reference's semantics (it likewise ships pickled python
between trusted job workers; this is an intra-job control channel, not an
open endpoint).

Every frame is authenticated with HMAC-SHA256 over a per-job secret: a
frame whose tag does not verify is dropped BEFORE unpickling.  Trust
boundary: by default rank 0 mints the secret and
publishes it through the UNAUTHENTICATED TCPStore rendezvous, so the HMAC
only protects against peers who cannot reach the rendezvous master — any
process that can talk to the master endpoint during init can read the
secret.  For a stronger boundary set ``PADDLE_RPC_SECRET`` (hex string,
**at least 32 characters** — enforced) in every worker's environment; the
secret then never transits the store and reaching the master is NOT enough
to forge frames.  The cross-rank consistency check publishes only an HMAC
of the secret keyed by a per-job random nonce — never a deterministic
fingerprint an observer of the store could brute-force offline. The server
binds to the interface that routes to the rendezvous master (or
``PADDLE_LOCAL_IP``), not 0.0.0.0, and the same address is advertised to
peers (``gethostbyname(gethostname())`` resolves to 127.0.1.1 on some
distros, silently breaking cross-host calls).

    rpc.init_rpc("worker0", rank=0, world_size=2, master_endpoint="ip:port")
    fut = rpc.rpc_async("worker1", max, args=(3, 5))
    assert fut.wait() == 5
    rpc.shutdown()
"""

from __future__ import annotations

import hmac
import pickle
import socket
import struct
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional

from .store import TCPStore, _recv_exact, rendezvous

__all__ = ["init_rpc", "shutdown", "rpc_sync", "rpc_async",
           "get_worker_info", "get_all_worker_infos",
           "get_current_worker_info", "WorkerInfo"]

_DEFAULT_RPC_TIMEOUT = 30.0
# cap on one frame's payload, checked BEFORE any buffering: the length
# prefix is attacker-controlled pre-auth, so an unauthenticated peer must
# not be able to make the server allocate unbounded memory
_MAX_FRAME_BYTES = 256 * 1024 * 1024


class WorkerInfo:
    """reference `rpc.py` WorkerInfo(name, rank, ip, port)."""

    def __init__(self, name: str, rank: int, ip: str, port: int):
        self.name, self.rank, self.ip, self.port = name, rank, ip, port

    def __repr__(self):
        return (f"WorkerInfo(name={self.name!r}, rank={self.rank}, "
                f"ip={self.ip!r}, port={self.port})")


class _State:
    store: Optional[TCPStore] = None
    server: Optional[socket.socket] = None
    server_thread: Optional[threading.Thread] = None
    pool: Optional[ThreadPoolExecutor] = None
    client_pool: Optional[ThreadPoolExecutor] = None
    current: Optional[WorkerInfo] = None
    workers: Dict[str, WorkerInfo] = {}
    secret: bytes = b""
    stop = threading.Event()


def _send_blob(sock: socket.socket, blob: bytes, secret: bytes) -> None:
    tag = hmac.new(secret, blob, "sha256").digest()
    sock.sendall(struct.pack("!Q", len(blob)) + tag + blob)


def _recv_blob(sock: socket.socket, secret: bytes) -> bytes:
    """Receive one frame and verify its HMAC BEFORE the payload is ever
    unpickled; raises PermissionError on tag mismatch."""
    (n,) = struct.unpack("!Q", _recv_exact(sock, 8))
    if n > _MAX_FRAME_BYTES:
        raise PermissionError(f"rpc frame length {n} exceeds cap")
    tag = _recv_exact(sock, 32)
    blob = _recv_exact(sock, n)
    if not hmac.compare_digest(tag, hmac.new(secret, blob, "sha256").digest()):
        raise PermissionError("rpc frame failed HMAC authentication")
    return blob


def _local_ip(master_endpoint: str) -> str:
    """The address peers should dial: PADDLE_LOCAL_IP if set, else the
    interface that routes to the rendezvous master (UDP connect trick — no
    packet is sent)."""
    import os

    ip = os.environ.get("PADDLE_LOCAL_IP")
    if ip:
        return ip
    host, _, port = master_endpoint.rpartition(":")
    probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        probe.connect((host, int(port)))
        return probe.getsockname()[0]
    except OSError:
        return socket.gethostbyname(socket.gethostname())
    finally:
        probe.close()


def _serve(conn: socket.socket) -> None:
    try:
        with conn:
            try:
                blob = _recv_blob(conn, _State.secret)
            except PermissionError:
                return  # unauthenticated frame: drop silently
            fn, args, kwargs = pickle.loads(blob)
            try:
                result = ("ok", fn(*args, **kwargs))
            except BaseException as e:  # ship the failure to the caller
                result = ("err", e)
            try:
                payload = pickle.dumps(result,
                                       protocol=pickle.HIGHEST_PROTOCOL)
            except Exception as e:  # unpicklable result/exception: describe it
                payload = pickle.dumps(
                    ("err", RuntimeError(
                        f"rpc result not picklable: {e!r} (result was "
                        f"{type(result[1]).__name__})")))
            _send_blob(conn, payload, _State.secret)
    except (OSError, ConnectionError):
        pass  # caller gone / shutdown race


def _server_loop(srv: socket.socket, pool: ThreadPoolExecutor) -> None:
    while not _State.stop.is_set():
        try:
            conn, _ = srv.accept()
        except OSError:
            return  # socket closed by shutdown()
        pool.submit(_serve, conn)


def init_rpc(name: str, rank: Optional[int] = None,
             world_size: Optional[int] = None,
             master_endpoint: Optional[str] = None) -> None:
    """Register this worker and discover the others (reference `rpc.py:73`;
    env defaults PADDLE_WORKER_NAME/PADDLE_TRAINER_ID/PADDLE_TRAINERS_NUM/
    PADDLE_MASTER_ENDPOINT honored like the reference)."""
    import os

    if _State.current is not None:
        raise RuntimeError("init_rpc already called; shutdown() first")
    rank = int(os.environ.get("PADDLE_TRAINER_ID", -1)) if rank is None else rank
    world_size = int(os.environ.get("PADDLE_TRAINERS_NUM", 0)) \
        if world_size is None else world_size
    master_endpoint = master_endpoint or os.environ.get(
        "PADDLE_MASTER_ENDPOINT")
    if not master_endpoint or world_size <= 0:
        raise ValueError("init_rpc needs world_size and master_endpoint")

    ip = _local_ip(master_endpoint)
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((ip, 0))  # the rendezvous-facing interface, never 0.0.0.0
    srv.listen(64)
    port = srv.getsockname()[1]

    store = None
    try:
        store, node_rank = rendezvous(
            master_endpoint, world_size, job_id="rpc",
            node_rank=None if rank is None or rank < 0 else rank)
        # per-job frame-auth secret: out-of-band via PADDLE_RPC_SECRET if
        # set (the store rendezvous is unauthenticated — see module
        # docstring); otherwise rank 0 mints it and everyone reads it
        # through the store before any RPC socket accepts traffic
        import os as _os

        env_secret = _os.environ.get("PADDLE_RPC_SECRET")
        if node_rank == 0:
            store.set("rpc/secret_source", b"env" if env_secret else b"store")
        store.wait(["rpc/secret_source"], timeout=_DEFAULT_RPC_TIMEOUT * 10)
        source = bytes(store.get("rpc/secret_source")).decode()
        if source == "env" and not env_secret:
            raise RuntimeError(
                "rank 0 uses PADDLE_RPC_SECRET but it is not set on this "
                "rank — set it on every worker (partial deployment would "
                "hang on the first call)")
        if env_secret and source != "env":
            raise RuntimeError(
                "PADDLE_RPC_SECRET is set on this rank but not on rank 0 — "
                "set it everywhere or nowhere")
        import secrets as _secrets

        if env_secret:
            if len(env_secret) < 32:
                raise RuntimeError(
                    "PADDLE_RPC_SECRET must be at least 32 characters (its "
                    "digest crosses the UNAUTHENTICATED job store for the "
                    "consistency check below, so a short secret would be "
                    "exposed to offline guessing) — use e.g. "
                    "`openssl rand -hex 32`")
            secret = env_secret.encode()
        else:
            if node_rank == 0:
                store.set("rpc/secret", _secrets.token_hex(32).encode())
            store.wait(["rpc/secret"], timeout=_DEFAULT_RPC_TIMEOUT * 10)
            secret = bytes(store.get("rpc/secret"))
        # consistency check: a PARTIAL PADDLE_RPC_SECRET deployment (some
        # ranks env, some store) would otherwise degrade to silent dropped
        # frames / timeouts — every rank publishes a digest of the secret
        # it will actually use, rank 0's is the reference.  The digest is
        # keyed by a PER-JOB RANDOM NONCE (never a bare hash of the
        # secret): anything published on the unauthenticated store is
        # readable by anyone who can reach it, and a deterministic
        # fingerprint of a human-chosen secret would hand out a free
        # offline brute-force target.  The nonce makes each job's digest
        # unlinkable across jobs and useless without the nonce's window.
        import hashlib as _hashlib
        import hmac as _hmac

        if node_rank == 0:
            store.set("rpc/secret_nonce", _secrets.token_hex(16).encode())
        store.wait(["rpc/secret_nonce"], timeout=_DEFAULT_RPC_TIMEOUT * 10)
        nonce = bytes(store.get("rpc/secret_nonce"))
        digest = _hmac.new(secret, b"rpc-secret-check:" + nonce,
                           _hashlib.sha256).hexdigest()
        if node_rank == 0:
            store.set("rpc/secret_digest", digest.encode())
        store.wait(["rpc/secret_digest"], timeout=_DEFAULT_RPC_TIMEOUT * 10)
        ref = bytes(store.get("rpc/secret_digest")).decode()
        if ref != digest:
            raise RuntimeError(
                "rpc secret mismatch: this rank's frame-auth secret differs "
                "from rank 0's (PADDLE_RPC_SECRET set on some ranks but not "
                "all?) — refusing to start, every call would silently hang")
        info = WorkerInfo(name, node_rank, ip, port)
        store.set(f"rpc/worker/{name}",
                  pickle.dumps((name, node_rank, ip, port)))
        # wait until every worker published, then snapshot the directory
        import time

        t0 = time.time()
        while True:
            keys = list(store.keys("rpc/worker/"))
            if len(keys) >= world_size:
                break
            if time.time() - t0 > _DEFAULT_RPC_TIMEOUT * 10:
                raise TimeoutError(f"only {len(keys)}/{world_size} rpc "
                                   f"workers registered")
            time.sleep(0.05)
        workers = {}
        for k in keys:
            wname, wrank, wip, wport = pickle.loads(store.get(k))
            workers[wname] = WorkerInfo(wname, wrank, wip, wport)
    except BaseException:
        # failed mid-init: nothing is published to _State, so shutdown()
        # would be a no-op — release the bound socket/store here
        srv.close()
        if store is not None:
            store.close()
        raise

    _State.stop.clear()
    _State.store = store
    _State.secret = secret
    _State.server = srv
    # separate pools: blocked outbound client calls must never starve the
    # threads that serve INCOMING requests (mutual-callback deadlock)
    _State.pool = ThreadPoolExecutor(max_workers=8,
                                     thread_name_prefix="paddle-rpc-srv")
    _State.client_pool = ThreadPoolExecutor(
        max_workers=8, thread_name_prefix="paddle-rpc-cli")
    _State.current = info
    _State.workers = workers
    _State.server_thread = threading.Thread(
        target=_server_loop, args=(srv, _State.pool), daemon=True)
    _State.server_thread.start()


def _call(to: str, fn, args, kwargs, timeout: float):
    try:
        target = _State.workers[to]
    except KeyError:
        raise ValueError(f"unknown rpc worker {to!r}; known: "
                         f"{sorted(_State.workers)}")
    with socket.create_connection((target.ip, target.port),
                                  timeout=timeout) as sock:
        sock.settimeout(timeout)
        _send_blob(sock, pickle.dumps((fn, tuple(args or ()), kwargs or {}),
                                      protocol=pickle.HIGHEST_PROTOCOL),
                   _State.secret)
        status, payload = pickle.loads(_recv_blob(sock, _State.secret))
    if status == "err":
        raise payload
    return payload


def rpc_sync(to: str, fn, args=None, kwargs=None,
             timeout: float = _DEFAULT_RPC_TIMEOUT):
    """Blocking call on worker ``to`` (reference `rpc.py:143`)."""
    if _State.current is None:
        raise RuntimeError("call init_rpc first")
    return _call(to, fn, args, kwargs, timeout)


def rpc_async(to: str, fn, args=None, kwargs=None,
              timeout: float = _DEFAULT_RPC_TIMEOUT) -> Future:
    """Future-returning call (reference `rpc.py:183`; ``.wait()`` like the
    reference's FutureWrapper)."""
    if _State.current is None:
        raise RuntimeError("call init_rpc first")
    fut = _State.client_pool.submit(_call, to, fn, args, kwargs, timeout)
    fut.wait = fut.result  # reference FutureWrapper API
    return fut


def get_worker_info(name: str) -> WorkerInfo:
    return _State.workers[name]


def get_all_worker_infos() -> List[WorkerInfo]:
    return sorted(_State.workers.values(), key=lambda w: w.rank)


def get_current_worker_info() -> WorkerInfo:
    if _State.current is None:
        raise RuntimeError("call init_rpc first")
    return _State.current


def shutdown() -> None:
    """Barrier with the other workers, then tear the server down (reference
    `rpc.py:278` performs the same world-synchronized exit)."""
    if _State.current is None:
        return
    import time

    try:
        _State.store.add("rpc/shutdown", 1)
        t0 = time.time()
        # add(, 0) reads the counter without bumping it
        while _State.store.add("rpc/shutdown", 0) < len(_State.workers):
            if time.time() - t0 > _DEFAULT_RPC_TIMEOUT:
                break
            time.sleep(0.05)
    except Exception:
        pass
    _State.stop.set()
    try:
        _State.server.close()
    except OSError:
        pass
    _State.pool.shutdown(wait=False)
    if _State.client_pool is not None:
        _State.client_pool.shutdown(wait=False)
    try:
        _State.store.close()
    except Exception:
        pass
    _State.current = None
    _State.workers = {}
    _State.secret = b""
    _State.store = None
