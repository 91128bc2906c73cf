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

Fleet fault domain (``--fault_domain on|off``, default on unless
``PADDLE_TPU_FAULT_DOMAIN`` is ``0``/``false``, as in the reference): the
launcher hosts (one node) or joins (several: the rendezvous store doubles
as it) the job's TCP store and exports ``PADDLE_TPU_FLEET_STORE``, so every
rank that calls ``init_parallel_env`` publishes a heartbeat lease and polls
the poison key.  The launcher that hosts the store runs the lease monitor
(a rank whose lease expires is poisoned, ``lease_expired``), and the watch
loop is poison-aware both ways: the first dead child writes the poison pill
(``rank_exit``) so siblings wedged in a collective exit 101 in bounded
time, and a pill written by anyone else (a rank's ``CommWatchdog``, a
``HealthGuard`` escalation, the SDC or straggler ladder) tears this pod
down too.  Teardown gives the ranks ``PADDLE_TPU_TEARDOWN_GRACE`` seconds
to leave on their own, then TERM, the same grace, then KILL.  The final
poison doc is written to ``<log_dir>/poison.json``, so a quarantine
decision survives the epoch's store.  ``PADDLE_TPU_DEVICE_ORDER`` (the
straggler ladder's link remap, exported by the ``FleetSupervisor``) gives
each rank its ring position (``PADDLE_TPU_RING_POS``); a permutation that
does not fit this epoch's world is dropped.

``--mode serve`` runs a serving pod instead: ``nproc_per_node`` replica
children under a ``ReplicaPool`` (each relaunched alone with backoff when
it dies, retired by exit 0), each given the fleet env contract
(``PADDLE_TPU_FLEET_STORE``, ``PADDLE_TPU_SNAP_STORE``,
``PADDLE_TPU_SERVE_REPLICA``, ``PADDLE_TPU_SERVE_TIER``) and expected to
call ``serving.fleet.run_replica``; ``PADDLE_TPU_DISAGG_PREFILL=K`` makes
the first K children the prefill tier, and ``PADDLE_TPU_AS_ENABLE=1``
hosts the ``serving.autoscaler.Autoscaler`` beside the loop.  Every
process's flight recorder dumps into the job's epoch dir (``log_dir``,
exported as ``PADDLE_TPU_EPOCH_DIR``); at the end the launcher dumps its
own, rolls the metrics depot up into ``metrics_rollup.json`` and merges
every dump into one causally ordered timeline (``telemetry.blackbox``).
"""

from __future__ import annotations

import argparse
import json
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
                        "serve: independent replicas, relaunched one at a time")
    p.add_argument("--max_replica_restarts", type=int,
                   default=int(os.environ.get("PADDLE_TPU_SERVE_MAX_RESTARTS", "5")),
                   help="serve mode: per-replica relaunch budget")
    p.add_argument("--fault_domain", choices=("on", "off"),
                   default=("off" if os.environ.get("PADDLE_TPU_FAULT_DOMAIN", "1")
                            in ("0", "false") else "on"),
                   help="heartbeat-lease/poison fault domain over the job store "
                        "(default on; env PADDLE_TPU_FAULT_DOMAIN)")
    p.add_argument("script", type=str, help="training script")
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def _record_event(name: str, **data) -> None:
    try:  # flight recorder: the pod's watch-loop story
        from ... import telemetry

        telemetry.record_event("gang", name, **data)
    except Exception:
        pass


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


class _PodWatch:
    """The launcher's membership in the fault domain: store hosting/joining,
    lease monitor, poison pill plumbing. All methods are best-effort — a
    fault-domain hiccup must never take down a healthy pod."""

    def __init__(self, store, world: int, job_id: str, own_store: bool):
        from ..fleet.fault_domain import FaultDomain

        self.own_store = own_store
        self.poisoned: Optional[dict] = None
        self.domain = FaultDomain(
            store, rank=None, world_size=world, job_id=job_id,
            epoch=int(os.environ.get("PADDLE_TPU_GANG_EPOCH", "0")),
            # only the store-hosting launcher monitors leases (one poisoner
            # per gang is enough; the pill is first-writer-wins anyway)
            monitor=own_store,
            on_abort=self._on_poison)
        self.domain.start()

    def _on_poison(self, doc: dict) -> None:
        self.poisoned = doc

    def poison(self, reason: str, culprit: Optional[int], detail: str) -> None:
        try:
            self.domain.poison(reason, culprit=culprit, detail=detail)
        except Exception:
            pass

    def stop(self) -> None:
        try:
            self.domain.stop()
        except Exception:
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
    nproc = args.nproc_per_node
    excluded_slots, live_slots = _slots(args.nnodes, nproc)
    world = len(live_slots)
    device_order = _device_order(world)
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

    # fleet fault domain: one node hosts a store of its own (the master
    # port stays free for the process group); several nodes reuse the
    # rendezvous store, whose server lives on the master host
    fleet_store_addr = None
    watch: Optional[_PodWatch] = None
    fleet_store = store
    if args.fault_domain == "on":
        try:
            from ..store import TCPStore

            if fleet_store is None:
                fleet_store = TCPStore("127.0.0.1", 0, is_master=True, world_size=world)
                fleet_store_addr = f"127.0.0.1:{fleet_store.port}"
            else:
                fleet_store_addr = master
            watch = _PodWatch(fleet_store, world, args.job_id,
                              own_store=fleet_store.is_master)
        except Exception as e:
            sys.stderr.write(f"[launch] fault domain unavailable: {e!r}\n")
            fleet_store_addr, watch = None, None
    snap: Optional[_SnapWatch] = None
    if os.environ.get("PADDLE_TPU_SNAP", "1") not in ("0", "false"):
        try:
            snap = _SnapWatch(fleet_kv=store if args.nnodes > 1 else None,
                              advertise_host=master.rsplit(":", 1)[0]
                              if args.nnodes > 1 else None)
        except OSError as e:  # snapshots degrade; the job still runs
            sys.stderr.write(f"[launch] snapshot store unavailable: {e!r}\n")
    os.makedirs(args.log_dir, exist_ok=True)
    # the job's epoch dir: every process (the launcher too) dumps its flight
    # recorder and spills its metrics here, so blackbox.merge folds one
    # causally ordered timeline
    os.environ["PADDLE_TPU_EPOCH_DIR"] = os.path.abspath(args.log_dir)

    if args.mode == "serve":
        # a serving pod: the same store and depot as a training pod (the
        # depot is also the fleet's journal depot), but supervised per
        # replica: no gang poisoning, no first-failure teardown
        try:
            return _serve_pod(args, node_rank, fleet_store_addr, snap)
        finally:
            _observability_teardown(args.log_dir, snap)
            if watch is not None:
                watch.stop()
            if snap is not None:
                snap.stop()
            if fleet_store is not None:
                fleet_store.close()

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
                _record_event("slot_excluded", slot=slot, local=local, node_rank=node_rank)
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
                **({"PADDLE_TPU_FLEET_STORE": fleet_store_addr,
                    "PADDLE_TPU_FLEET_MONITOR": "launcher"} if fleet_store_addr else {}),
                **({"PADDLE_TPU_SNAP_STORE": snap.addr} if snap else {}),
                # ring position under the (possibly remapped) device order
                **({"PADDLE_TPU_RING_POS": str(device_order.index(rank))}
                   if device_order else {}),
                "PADDLE_NPROC_PER_NODE": str(nproc),
            })
            log_f = open(os.path.join(args.log_dir, f"workerlog.{rank}"), "w")
            logs.append(log_f)
            procs.append(subprocess.Popen(
                [sys.executable, "-u", args.script, *args.script_args],
                env=env, stdout=log_f, stderr=subprocess.STDOUT))
            ranks[procs[-1].pid] = rank
        _record_event("gang_start", world=world, node_rank=node_rank, nproc=nproc,
                      epoch=int(os.environ.get("PADDLE_TPU_GANG_EPOCH", "0")),
                      fault_domain=args.fault_domain,
                      **({"device_order": device_order} if device_order else {}))
    except BaseException:
        # a failed spawn must not leave earlier workers blocked on a
        # rendezvous that will never complete
        for pr in procs:
            pr.kill()
        for f in logs:
            f.close()
        if watch is not None:
            watch.stop()
        if snap is not None:
            snap.stop()
        if fleet_store is not None:
            fleet_store.close()
        raise

    def _teardown(remaining: List[subprocess.Popen], self_exit_window: float) -> None:
        """Poisoned ranks exit on their own within the poison deadline:
        give them ``self_exit_window`` to finish emergency checkpoints,
        then TERM, then KILL after ``grace`` (a rank wedged in an
        uninterruptible wait ignores TERM)."""
        deadline = time.time() + self_exit_window
        while remaining and time.time() < deadline:
            remaining = [pr for pr in remaining if pr.poll() is None]
            if remaining:
                time.sleep(0.1)
        for pr in remaining:
            if pr.poll() is None:
                pr.terminate()
        for pr in remaining:
            try:
                pr.wait(timeout=grace)
            except subprocess.TimeoutExpired:
                pr.kill()
                pr.wait()
        _record_event("gang_teardown", world=world, killed=len(remaining))

    rc = 0
    try:
        while procs:
            for pr in list(procs):
                code = pr.poll()
                if code is None or pr not in procs:
                    continue
                procs.remove(pr)
                _record_event("gang_child_exit", rank=ranks.get(pr.pid), exit_code=code)
                if snap is not None:
                    # spontaneous deaths only: the teardowns below are
                    # the launcher's own, and the host RAM stays
                    snap.note_child_exit(ranks.get(pr.pid), code)
                if code == 0 and watch is not None and ranks.get(pr.pid) is not None:
                    # a clean exit that never stopped its domain must not
                    # leave a lease behind to expire and poison survivors
                    watch.domain.release_rank(ranks[pr.pid])
                if code != 0:
                    if snap is not None:
                        # siblings that died in the same window lose their
                        # holdings too (a rank and its replica holder)
                        for other in procs:
                            oc = other.poll()
                            if oc is not None:
                                snap.note_child_exit(ranks.get(other.pid), oc)
                    # the first failure tears down the pod (reference
                    # CollectiveController watch loop) — poison FIRST so
                    # ranks wedged in a collective turn the hang into
                    # their own bounded exit and emergency checkpoint
                    rc = code
                    if watch is not None and procs:
                        watch.poison("rank_exit", ranks.get(pr.pid), f"exit code {code}")
                        _teardown(procs, self_exit_window=grace)
                    else:
                        _teardown(procs, self_exit_window=0.0)
                    procs.clear()
            if procs and watch is not None and watch.poisoned is not None:
                # someone ELSE poisoned the gang (a rank's watchdog, a
                # health escalation, a dead lease on another pod): every
                # local child leaves too, the healthy ones included
                doc = watch.poisoned
                _record_event("gang_poisoned", reason=doc.get("reason"),
                              culprit=doc.get("culprit"), by=doc.get("by"))
                _teardown(procs, self_exit_window=grace)
                for pr in procs:
                    code = pr.poll()
                    if code and not rc:
                        rc = code
                procs.clear()
                if not rc:
                    rc = 101        # a poisoned gang is not a clean completion
            time.sleep(0.2)
    except KeyboardInterrupt:
        for pr in procs:
            pr.send_signal(signal.SIGINT)
        rc = 130
    finally:
        for f in logs:
            f.close()
        if watch is not None:
            _dump_poison(watch, args.log_dir)
            watch.stop()
        _observability_teardown(args.log_dir, snap)
        if snap is not None:
            snap.stop()
        if store is not None:
            _leave_rendezvous(store, args.nnodes, args.job_id, grace)
        if fleet_store is not None:
            fleet_store.close()
    return rc


def _leave_rendezvous(store, nnodes: int, job_id: str, grace: float) -> None:
    """Several nodes: the store's host (the master's pod) outlives its
    clients.  Each pod says it is done; the host waits for every pod (at
    most ``grace`` seconds past a slow one) before its store closes, so a
    pod still releasing a lease or reading the pill never finds the store
    gone and waits out a reconnect."""
    try:
        store.add(f"{job_id}/pods_done", 1)
        if not store.is_master:
            return
        deadline = time.time() + max(grace, 5.0)
        while time.time() < deadline and \
                store.add(f"{job_id}/pods_done", 0) < nnodes:
            time.sleep(0.05)
    except (OSError, RuntimeError):
        pass


def _device_order(world: int) -> Optional[List[int]]:
    """The straggler ladder's link remap (``PADDLE_TPU_DEVICE_ORDER``, a
    permutation of the dense ranks exported by the ``FleetSupervisor``),
    or None; one that does not fit this epoch's world (stale after a later
    exclusion) is dropped loudly, never obeyed."""
    raw = os.environ.get("PADDLE_TPU_DEVICE_ORDER", "").strip()
    if not raw:
        return None
    try:
        order = [int(t) for t in raw.split(",") if t.strip()]
    except ValueError:
        order = None
    if order is None or sorted(order) != list(range(world)):
        _record_event("device_order_dropped", order=raw, world=world)
        return None
    return order


def _dump_poison(watch: "_PodWatch", log_dir: str) -> None:
    """Persist the poison doc for the ``FleetSupervisor``: the pill dies
    with the epoch's store, but a quarantine decision must survive
    teardown (the dump names the rank the exclude-list relaunch removes)."""
    doc = watch.poisoned
    if doc is None:
        try:
            doc = watch.domain.check_poison()
        except Exception:
            doc = None
    if doc is not None:
        try:
            with open(os.path.join(log_dir, "poison.json"), "w") as f:
                json.dump(doc, f, indent=1)
        except (OSError, TypeError, ValueError):
            pass


def _observability_teardown(log_dir: str, snap) -> None:
    """Job-level observability epilogue (best-effort, never raises):
    dump the launcher's own flight recorder next to the workers' dumps,
    pull the metrics depot into one ``metrics_rollup.json``, and fold
    every per-process dump into the merged black-box timeline."""
    try:
        from ... import telemetry
        telemetry.dump_flight_recorder(
            os.path.join(log_dir, f"flight_launcher_pid{os.getpid()}.json"),
            reason="launch_teardown")
    except Exception:
        pass
    if snap is not None and getattr(snap, "addr", None):
        try:
            import json

            from ...telemetry.aggregator import rollup
            from ..checkpoint.replicator import SnapshotClient
            cli = SnapshotClient.from_address(snap.addr)
            try:
                snaps = cli.metrics_pull()
            finally:
                cli.close()
            if snaps:
                with open(os.path.join(log_dir, "metrics_rollup.json"),
                          "w") as f:
                    json.dump(rollup(snaps), f, indent=1, default=repr)
        except Exception:
            pass
    try:
        from ...telemetry import blackbox
        blackbox.merge(log_dir)
    except Exception:
        pass


def _serve_pod(args, node_rank: int, fleet_store_addr: Optional[str],
               snap) -> int:
    """Serve-mode watch loop: ``nproc_per_node`` replica children under a
    :class:`~..fleet.elastic.supervisor.ReplicaPool`.  Each child gets the
    fleet env contract (``PADDLE_TPU_FLEET_STORE`` for its heartbeat
    lease, ``PADDLE_TPU_SNAP_STORE`` for journal shipping,
    ``PADDLE_TPU_SERVE_REPLICA`` for its stable name) and is expected to
    call :func:`paddle_tpu_torch.serving.fleet.run_replica`.  A SIGKILL'd or
    101-exiting replica relaunches alone with backoff and adopts a fresh
    fencing epoch; exit 0 (frontend said stop) retires it.

    With ``PADDLE_TPU_AS_ENABLE=1`` (and a fleet store to scan) the pod
    also hosts the :class:`~paddle_tpu_torch.serving.autoscaler.Autoscaler`
    next to this loop: fleet occupancy / shed pressure grows the pool
    through ``scale_to`` (fresh names, fresh fencing epochs) and shrinks it through the lossless
    retire → re-home → stop drain protocol — drained stops exit 0 and
    burn no restart budget."""
    from ..fleet.elastic.supervisor import ReplicaPool, RestartPolicy

    pool = ReplicaPool(
        policy=RestartPolicy(max_restarts=args.max_replica_restarts),
        restart_codes=(101, -signal.SIGKILL, -signal.SIGTERM))
    argv = [sys.executable, "-u", args.script, *args.script_args]
    base_env = {
        "PADDLE_JOB_ID": args.job_id,
        **({"PADDLE_TPU_FLEET_STORE": fleet_store_addr}
           if fleet_store_addr else {}),
        **({"PADDLE_TPU_SNAP_STORE": snap.addr} if snap else {}),
    }
    # the disaggregated tier topology: with
    # PADDLE_TPU_DISAGG_PREFILL=K the pod's FIRST K children form a
    # dedicated prefill tier (named prefill{N}, tier=prefill on their
    # lease) and the rest stay decode replicas.  The router prefers
    # prefill capacity for TTFT-bound work and falls back to the whole
    # fleet when the tier is empty — K >= nproc_per_node degrades to a
    # homogeneous (all-prefill-tagged) pod rather than refusing.
    n_prefill = max(0, int(os.environ.get("PADDLE_TPU_DISAGG_PREFILL",
                                          "0") or 0))
    for local in range(args.nproc_per_node):
        idx = node_rank * args.nproc_per_node + local
        tier = "prefill" if local < n_prefill else "decode"
        name = (f"prefill{idx}" if tier == "prefill" else f"replica{idx}")
        pool.add(name, argv,
                 env={**base_env, "PADDLE_LOCAL_RANK": str(local),
                      "PADDLE_TPU_SERVE_TIER": tier},
                 log_path=os.path.join(args.log_dir, f"{name}.log"))
    # scale-outs reuse the same child contract; their names continue the
    # pod's replica index sequence so they can never collide with (or
    # inherit budget from) an existing or retired replica.  Autoscaled
    # capacity is always DECODE tier: the prefill tier is a fixed split.
    pool.set_template(argv, env={**base_env, "PADDLE_LOCAL_RANK": "0",
                                 "PADDLE_TPU_SERVE_TIER": "decode"},
                      log_dir=args.log_dir, name_prefix="replica")
    scaler = None
    if os.environ.get("PADDLE_TPU_AS_ENABLE", "0") == "1" \
            and fleet_store_addr and node_rank == 0:
        try:
            from ...serving.autoscaler import Autoscaler
            from ..checkpoint.replicator import SnapshotClient
            from ..store import TCPStore

            h, p = fleet_store_addr.rsplit(":", 1)
            as_store = TCPStore(h, int(p), is_master=False)
            as_depot = SnapshotClient.from_address(snap.addr) \
                if snap is not None and getattr(snap, "addr", None) else None
            scaler = Autoscaler(as_store, as_depot, pool=pool)
            scaler.start()
        except Exception:
            scaler = None   # autoscaling is additive: never block serving
    _record_event("serve_pod_start", replicas=args.nproc_per_node,
                  node_rank=node_rank, prefill_tier=n_prefill,
                  autoscale=scaler is not None)
    rc = 0
    try:
        pool.start()
        while not pool.all_exited():
            pool.poll_once()
            time.sleep(0.2)
        if pool.given_up:
            rc = 101   # at least one replica burned its relaunch budget
    except KeyboardInterrupt:
        rc = 130
    finally:
        if scaler is not None:
            scaler.stop()
        pool.stop()
        _record_event("serve_pod_done", given_up=sorted(pool.given_up),
                      restarts=dict(pool.restarts),
                      scale_outs=0 if scaler is None else scaler.scale_outs,
                      scale_ins=0 if scaler is None else scaler.scale_ins,
                      rc=rc)
    return rc


def main() -> None:
    raise SystemExit(launch())


if __name__ == "__main__":
    main()
