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

In-memory snapshots (``PADDLE_TPU_SNAP``, on unless ``0``/``false``, as
in the reference): the launcher hosts the snapshot depot
(``checkpoint.replicator.SnapshotStore``, standing in for per-host RAM, so
a worker's snapshot copies survive a SIGKILL'd rank) and exports
``PADDLE_TPU_SNAP_STORE`` so that every rank's ``Snapshotter`` ships its
own copy and its ring neighbour's replica there.  A worker that dies
uncoordinated (a signal, or an exit other than 0 and 101) has the copies
it held dropped, which is what makes the double fault (a rank and its
replica holder lost together) fall back to the disk checkpoint.  With
several nodes the master's pod hosts the one depot and publishes its
address through the job's store.

Left for later queue items, each refusing to start rather than running
without it: the fleet fault domain with its heartbeat leases, lease
monitor and poison-aware watch loop (``--fault_domain on``, ROADMAP A7b;
the port's default is ``off``, a departure from the reference's ``on``)
and serving mode (``--mode serve``, A8).  The reference's observability
epilogue (the flight-recorder dump, metrics roll-up and black-box merge,
A8) has no switch: it is left out, as is the ring remap its fleet
supervisor exports (``PADDLE_TPU_DEVICE_ORDER``, A7b).
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time
from typing import List, Optional

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
                        "(default off: not ported yet, ROADMAP A7b; env "
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
                                  "not ported yet (ROADMAP A7b); use --fault_domain off")


class _SnapWatch:
    """The launcher's part in the snapshot depot: host it (or take the
    address already exported) and turn a worker's uncoordinated death into
    dropping the copies it held."""

    def __init__(self, fleet_kv=None, advertise_host: Optional[str] = None):
        from ..checkpoint import replicator

        self.addr = os.environ.get("PADDLE_TPU_SNAP_STORE")
        if not self.addr and fleet_kv is not None:
            # several nodes: one depot for the gang, hosted by the pod of
            # the master host and published through the job's store
            if getattr(fleet_kv, "is_master", False):
                depot, local = replicator.ensure_host_store()
                self.addr = f"{advertise_host}:{depot.port}" if advertise_host else local
                fleet_kv.set("snap/store", self.addr)
            else:
                self.addr = fleet_kv.get("snap/store", timeout=60.0).decode()
        if not self.addr:
            # one node: the process's own depot, which outlives this launch
            _, self.addr = replicator.ensure_host_store()
        self._client = replicator.SnapshotClient.from_address(self.addr)

    def note_child_exit(self, rank: Optional[int], code: int) -> None:
        """Exit 0 (done) or 101 (a coordinated abort) keeps the copies the
        rank held; any other exit models the loss of its host's RAM."""
        if rank is None or code in (0, 101):
            return
        try:
            dropped = self._client.drop_holder(rank)
        except OSError:
            return
        if dropped:
            from ... import telemetry

            telemetry.record_event("snapshot_holder_dropped", "launch", rank=rank,
                                   exit_code=code, copies_dropped=dropped)

    def stop(self) -> None:
        # the depot itself stays up: a relaunch in this process finds it
        try:
            self._client.close()
        except OSError:
            pass


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
    snap: Optional[_SnapWatch] = None
    if os.environ.get("PADDLE_TPU_SNAP", "1") not in ("0", "false"):
        try:
            snap = _SnapWatch(fleet_kv=store if args.nnodes > 1 else None,
                              advertise_host=master.rsplit(":", 1)[0]
                              if args.nnodes > 1 else None)
        except OSError as e:  # snapshots degrade; the job still runs
            sys.stderr.write(f"[launch] snapshot store unavailable: {e!r}\n")
    os.makedirs(args.log_dir, exist_ok=True)

    grace = 10.0
    try:
        grace = float(os.environ.get("PADDLE_TPU_TEARDOWN_GRACE", grace))
    except ValueError:
        pass

    procs: List[subprocess.Popen] = []
    ranks = {}
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
                **({"PADDLE_TPU_SNAP_STORE": snap.addr} if snap else {}),
                "PADDLE_NPROC_PER_NODE": str(nproc),
            })
            log_f = open(os.path.join(args.log_dir, f"workerlog.{rank}"), "w")
            logs.append(log_f)
            procs.append(subprocess.Popen(
                [sys.executable, "-u", args.script, *args.script_args],
                env=env, stdout=log_f, stderr=subprocess.STDOUT))
            ranks[procs[-1].pid] = rank
    except BaseException:
        # a failed spawn must not leave earlier workers blocked on a
        # rendezvous that will never complete
        for pr in procs:
            pr.kill()
        for f in logs:
            f.close()
        if snap is not None:
            snap.stop()
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
                if snap is not None:
                    # spontaneous deaths only: the teardowns below are
                    # the launcher's own, and the host RAM stays
                    snap.note_child_exit(ranks.get(pr.pid), code)
                if code != 0:
                    if snap is not None:
                        # siblings that died in the same window lose their
                        # holdings too (a rank and its replica holder)
                        for other in procs:
                            oc = other.poll()
                            if oc is not None:
                                snap.note_child_exit(ranks.get(other.pid), oc)
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
        if snap is not None:
            snap.stop()
        if store is not None:
            store.close()
    return rc


def main() -> None:
    raise SystemExit(launch())


if __name__ == "__main__":
    main()
