"""``python -m paddle_tpu_torch.distributed.launch`` — the per-host process
launcher (port of the reference's ``distributed/launch/main.py``;
reference ``python/paddle/distributed/launch/main.py`` and
``controllers/collective.py:22`` CollectiveController.build_pod).

One pod per host.  Each worker process gets the PADDLE_* environment
contract (``parallel.py:687-710`` in the reference: ``PADDLE_TRAINER_ID``,
``PADDLE_TRAINERS_NUM``, ``PADDLE_MASTER``, ``PADDLE_LOCAL_RANK``, …) and
its own ``log_dir/workerlog.N``; ``distributed.init_parallel_env`` reads
it.  The first worker to fail tears the pod down (TERM, then
``PADDLE_TPU_TEARDOWN_GRACE`` seconds, then KILL) and the launcher exits
with that worker's code.  With several nodes the pods rendezvous through
the TCP store hosted on the ``--master`` host, which assigns node ranks;
the store holds the master port for the job, so the process group meets at
the next port (``PADDLE_COORDINATOR``).  ``PADDLE_TPU_EXCLUDE_SLOTS`` names
slots not to spawn (the survivors get dense ranks), as in the reference.

The launcher does not choose the backend: a worker on the card gets NCCL,
one rank per card, and one that called ``set_device("cpu")`` gets gloo
(``init_parallel_env``).

Left for later queue items, each refusing to start rather than running
without it: the fleet fault domain with its heartbeat leases, lease
monitor and poison-aware watch loop (``--fault_domain on``, ROADMAP A7;
the port's default is ``off``, a departure from the reference's ``on``),
the in-memory snapshot depot (``PADDLE_TPU_SNAP=1``, A7) and serving mode
(``--mode serve``, A8).  The reference's observability epilogue (the
flight-recorder dump, metrics roll-up and black-box merge, A8) has no
switch: it is left out, as is the ring remap its fleet supervisor
exports (``PADDLE_TPU_DEVICE_ORDER``, A7).
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time
from typing import List

__all__ = ["launch", "main"]


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _parse(argv):
    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch.distributed.launch",
        description="Launch a distributed training job (pod-per-host).")
    p.add_argument("--nnodes", type=int,
                   default=int(os.environ.get("PADDLE_NNODES", "1")),
                   help="number of hosts in the job")
    p.add_argument("--node_rank", type=int,
                   default=int(os.environ.get("PADDLE_NODE_RANK", "-1")),
                   help="rank of this host (-1: assigned by the master "
                        "rendezvous when nnodes > 1, else 0)")
    p.add_argument("--nproc_per_node", type=int,
                   default=int(os.environ.get("PADDLE_NPROC_PER_NODE", "1")),
                   help="worker processes on this host (NCCL: at most one a card)")
    p.add_argument("--master", type=str,
                   default=os.environ.get("PADDLE_MASTER"),
                   help="coordinator host:port (default: local free port)")
    p.add_argument("--log_dir", type=str, default="log",
                   help="directory for per-rank workerlog.N files")
    p.add_argument("--job_id", type=str, default="default",
                   help="job name tag (reference parity)")
    p.add_argument("--mode", choices=("train", "serve"),
                   default=os.environ.get("PADDLE_TPU_LAUNCH_MODE", "train"),
                   help="train: SPMD gang (first failure tears the pod down); "
                        "serve: not ported yet (ROADMAP A8)")
    p.add_argument("--max_replica_restarts", type=int,
                   default=int(os.environ.get("PADDLE_TPU_SERVE_MAX_RESTARTS", "5")),
                   help="serve mode: per-replica relaunch budget")
    p.add_argument("--fault_domain", choices=("on", "off"),
                   default=("on" if os.environ.get("PADDLE_TPU_FAULT_DOMAIN", "0")
                            in ("1", "true", "on") else "off"),
                   help="heartbeat-lease/poison fault domain over the job store "
                        "(default off: not ported yet, ROADMAP A7; env "
                        "PADDLE_TPU_FAULT_DOMAIN)")
    p.add_argument("script", type=str, help="training script")
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def _refuse_unported(args) -> None:
    if args.mode == "serve":
        raise NotImplementedError("launch --mode serve (the serving replica pool) is "
                                  "not ported yet (ROADMAP A8)")
    if args.fault_domain == "on":
        raise NotImplementedError("launch --fault_domain on (heartbeat leases, the "
                                  "lease monitor and the poison-aware watch loop) is "
                                  "not ported yet (ROADMAP A7); use --fault_domain off")
    if os.environ.get("PADDLE_TPU_SNAP", "0") not in ("0", "false", ""):
        raise NotImplementedError("PADDLE_TPU_SNAP: the in-memory snapshot depot is "
                                  "not ported yet (ROADMAP A7)")


def _slots(nnodes: int, nproc: int):
    """(the excluded physical slots, the live ones in rank order)."""
    excluded = set()
    for tok in os.environ.get("PADDLE_TPU_EXCLUDE_SLOTS", "").split(","):
        tok = tok.strip()
        if tok:
            try:
                excluded.add(int(tok))
            except ValueError:
                pass
    live = [s for s in range(nnodes * nproc) if s not in excluded]
    if not live:
        raise SystemExit("PADDLE_TPU_EXCLUDE_SLOTS excludes every slot")
    return excluded, live


def launch(argv=None) -> int:
    args = _parse(argv if argv is not None else sys.argv[1:])
    _refuse_unported(args)
    nproc = args.nproc_per_node
    excluded_slots, live_slots = _slots(args.nnodes, nproc)
    world = len(live_slots)
    master = args.master
    node_rank = args.node_rank
    store = None
    if master is None:
        if args.nnodes > 1:
            raise SystemExit("--master host:port is required when nnodes > 1")
        master = f"127.0.0.1:{_free_port()}"
    coordinator = None
    if args.nnodes > 1:
        # multi-node: rendezvous through the TCP store served from the
        # master host (reference `controllers/master.py:73` HTTPMaster):
        # it assigns node ranks, publishes hostnames and barriers all pods
        # before any worker spawns.  The store OWNS the master port for the
        # job, so the process group gets port+1 (PADDLE_COORDINATOR).
        from ..store import rendezvous

        store, node_rank = rendezvous(
            master, args.nnodes, job_id=args.job_id,
            node_rank=None if node_rank < 0 else node_rank)
        mhost, mport = master.rsplit(":", 1)
        coordinator = f"{mhost}:{int(mport) + 1}"
    elif node_rank < 0:
        node_rank = 0
    os.makedirs(args.log_dir, exist_ok=True)

    grace = 10.0
    try:
        grace = float(os.environ.get("PADDLE_TPU_TEARDOWN_GRACE", grace))
    except ValueError:
        pass

    procs: List[subprocess.Popen] = []
    logs = []
    try:
        for local in range(nproc):
            slot = node_rank * nproc + local
            if slot in excluded_slots:
                continue
            rank = live_slots.index(slot)
            env = os.environ.copy()
            env.update({
                "PADDLE_TRAINER_ID": str(rank),
                "PADDLE_TRAINERS_NUM": str(world),
                "PADDLE_MASTER": master,
                "PADDLE_LOCAL_RANK": str(local),
                "PADDLE_RANK_IN_NODE": str(local),
                "PADDLE_JOB_ID": args.job_id,
                "PADDLE_NNODES": str(args.nnodes),
                "PADDLE_NODE_RANK": str(node_rank),
                **({"PADDLE_COORDINATOR": coordinator} if coordinator else {}),
                "PADDLE_NPROC_PER_NODE": str(nproc),
            })
            log_f = open(os.path.join(args.log_dir, f"workerlog.{rank}"), "w")
            logs.append(log_f)
            procs.append(subprocess.Popen(
                [sys.executable, "-u", args.script, *args.script_args],
                env=env, stdout=log_f, stderr=subprocess.STDOUT))
    except BaseException:
        # a failed spawn must not leave earlier workers blocked on a
        # rendezvous that will never complete
        for pr in procs:
            pr.kill()
        for f in logs:
            f.close()
        if store is not None:
            store.close()
        raise

    def _teardown(remaining: List[subprocess.Popen]) -> None:
        """TERM, then KILL after ``grace`` (a rank wedged in an
        uninterruptible wait ignores TERM)."""
        for pr in remaining:
            if pr.poll() is None:
                pr.terminate()
        for pr in remaining:
            try:
                pr.wait(timeout=grace)
            except subprocess.TimeoutExpired:
                pr.kill()
                pr.wait()

    rc = 0
    try:
        while procs:
            for pr in list(procs):
                code = pr.poll()
                if code is None or pr not in procs:
                    continue
                procs.remove(pr)
                if code != 0:
                    # the first failure tears down the pod (reference
                    # CollectiveController watch loop)
                    rc = code
                    _teardown(procs)
                    procs.clear()
            time.sleep(0.2)
    except KeyboardInterrupt:
        for pr in procs:
            pr.send_signal(signal.SIGINT)
        rc = 130
    finally:
        for f in logs:
            f.close()
        if store is not None:
            store.close()
    return rc


def main() -> None:
    raise SystemExit(launch())


if __name__ == "__main__":
    main()
