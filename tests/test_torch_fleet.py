"""The port's serving fleet (``serving/fleet.py``, ``router.py``) against
the JAX package's, on the CPU.

- The reference's ``tests/test_serving_fleet.py`` runs on the port through
  ``port_reference`` (``test_torch_telemetry.py``): the router, the depot
  journal, the fake-clock lease failover, drain and hand-back, the double
  fault, the replica pool, and the SIGKILL-one-of-three chaos run of three
  replica processes (their script builds the port's model on the CPU).
  Its ``TestBeamSearchDeadBeams`` feeds JAX arrays to the beam search and
  is held by ``test_torch_beam_search.py`` instead.
- The router's picks and orders equal the reference's over random replica
  sets, deadlines and tiers.
- A two-replica ``ServingFrontend`` whose replica "a" crashes mid-stream
  (its lease left to expire) fences, folds and replays on "b": every
  stream is token-exact against the JAX package's frontend in the same
  run and against one engine, and the sink holds each token once.
- ``launch --mode serve`` runs a pod of two replica processes on the CPU
  (``set_device("cpu")`` in the replica script) behind a frontend,
  drains one and stops both with exit 0.
"""

import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.serving import Deadline as JaxDeadline
from paddle_tpu.serving import fleet as jfleet
from paddle_tpu.serving import journal as jjournal
from paddle_tpu.serving.router import ReplicaStatus as JaxStatus
from paddle_tpu.serving.router import Router as JaxRouter

import paddle_tpu_torch as ptt
from paddle_tpu_torch.convert import load_numpy_state_dict
from paddle_tpu_torch.models import LlamaForCausalLM as TorchLlama
from paddle_tpu_torch.models import llama_tiny
from paddle_tpu_torch.serving import fleet as tfleet
from paddle_tpu_torch.serving import journal as tjournal
from paddle_tpu_torch.serving.admission import Deadline as TorchDeadline
from paddle_tpu_torch.serving.router import ReplicaStatus as TorchStatus
from paddle_tpu_torch.serving.router import Router as TorchRouter

from test_torch_telemetry import _port_on_cpu, port_reference  # noqa: F401

torch.set_num_threads(1)

port_reference("test_serving_fleet", globals(), drop=("TestBeamSearchDeadBeams",), subs=[(
    '''    import jax
    jax.config.update("jax_platforms", "cpu")
    import paddle_tpu_torch as paddle
''', '''    import torch
    torch.set_num_threads(1)
    import paddle_tpu_torch as paddle
    paddle.set_device("cpu")
''')])


# ---------------------------------------------------------------------------
# the router, pick for pick
# ---------------------------------------------------------------------------
def _statuses(rng, Status, n):
    out = []
    for i in range(n):
        out.append(Status(
            name=f"r{int(rng.integers(0, 9))}{i}", address="inproc",
            capacity=int(rng.integers(1, 6)), queue_depth=int(rng.integers(0, 5)),
            active=int(rng.integers(0, 3)),
            est_first_token_s=None if rng.random() < 0.2 else float(rng.random() * 2),
            epoch=1, draining=bool(rng.random() < 0.2), warming=bool(rng.random() < 0.2),
            degraded=bool(rng.random() < 0.15),
            tier="prefill" if rng.random() < 0.3 else "decode"))
    return out


@pytest.mark.parametrize("seed", range(12))
def test_router_picks_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    for trial in range(20):
        n = int(rng.integers(1, 6))
        state = rng.bit_generator.state
        mine = _statuses(rng, TorchStatus, n)
        rng.bit_generator.state = state
        theirs = _statuses(rng, JaxStatus, n)
        ttft = None if rng.random() < 0.3 else float(rng.random() * 2)
        age = float(rng.random())
        tier = [None, "prefill", "decode"][int(rng.integers(0, 3))]
        dl_t = None if ttft is None else TorchDeadline(ttft_s=ttft)
        dl_j = None if ttft is None else JaxDeadline(ttft_s=ttft)
        a = TorchRouter().pick(mine, dl_t, age_s=age, tier=tier)
        b = JaxRouter().pick(theirs, dl_j, age_s=age, tier=tier)
        assert (a and a.name) == (b and b.name), (seed, trial)
        assert [s.name for s in TorchRouter().order(mine, dl_t, age_s=age, tier=tier)] == \
            [s.name for s in JaxRouter().order(theirs, dl_j, age_s=age, tier=tier)]


# ---------------------------------------------------------------------------
# a replica's death, token-exact against the JAX frontend and one engine
# ---------------------------------------------------------------------------
KW = dict(max_batch=3, page_tokens=8, num_pages=24, max_pages_per_seq=6)
PROMPT_LENS = (5, 9, 6, 12)
MAX_NEW = 5


@pytest.fixture(scope="module")
def pair():
    paddle.seed(3)
    jm = JaxLlama(jax_llama_tiny(num_hidden_layers=2, vocab_size=96,
                                 max_position_embeddings=128))
    jm.eval()
    tm = TorchLlama(llama_tiny(num_hidden_layers=2, vocab_size=96,
                               max_position_embeddings=128), device="cpu")
    load_numpy_state_dict(tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    tm.eval()
    return jm, tm


def _prompts():
    rng = np.random.default_rng(21)
    return [rng.integers(1, 96, n).astype(np.int32) for n in PROMPT_LENS]


def _fleet_with_death(F, J, model, tmp_path, depot_pair):
    """Two replicas behind a frontend; "a" crashes after its third token
    (its engine stops, its lease is left to expire).  Returns the sink's
    streams and the frontend's failover count."""
    SnapshotStore, SnapshotClient = depot_pair
    store = SnapshotStore(host="127.0.0.1")
    depot = SnapshotClient("127.0.0.1", store.port)
    kv = F.LocalKV()
    sink = J.TokenSink(str(tmp_path / "out.jsonl"))
    fe = F.ServingFrontend(kv, depot, sink=sink, auto_attach=False)
    crash = {"n": 0}

    def crashing_emit(rid, idx, tok):
        fe.emit(rid, idx, tok)
        crash["n"] += 1
        if crash["n"] >= 3:
            raise RuntimeError("replica crash mid-stream")

    ra = F.EngineReplica("a", model, store=kv, depot=depot, journal_root=str(tmp_path / "j"),
                         on_token=crashing_emit, engine_kw=KW)
    rb = F.EngineReplica("b", model, store=kv, depot=depot, journal_root=str(tmp_path / "j"),
                         on_token=fe.emit, engine_kw=KW)
    ra.lease.start()
    rb.lease.start()
    fe.attach(ra)
    fe.attach(rb)
    try:
        rids = [fe.submit(p, max_new_tokens=MAX_NEW) for p in _prompts()]
        # no status beat has run: both leases read empty, so the tie goes to "a"
        assert {fe.assignments[r] for r in rids} == {"a"}
        ra.start()
        deadline = time.monotonic() + 60
        while ra.error is None and time.monotonic() < deadline:
            time.sleep(0.02)
        assert ra.error is not None
        ra.die()
        rb.start()
        time.sleep(1.3)               # ttl 1.0 (tests/conftest.py): a's lease expires
        deadline = time.monotonic() + 30
        while fe.failovers == 0 and time.monotonic() < deadline:
            fe.scan_once()
            time.sleep(0.05)
        assert fe.wait_all(rids, timeout=120), fe.summary()
        return rids, J.TokenSink.collect(sink.path), fe.failovers, fe.replayed_requests
    finally:
        rb.stop()
        fe.stop()
        sink.close()
        depot.close()
        store.close()


def test_replica_death_is_token_exact_against_the_reference_and_one_engine(pair, tmp_path):
    from paddle_tpu.distributed.checkpoint.replicator import SnapshotClient as JC
    from paddle_tpu.distributed.checkpoint.replicator import SnapshotStore as JS
    from paddle_tpu_torch.distributed.checkpoint.replicator import SnapshotClient as TC
    from paddle_tpu_torch.distributed.checkpoint.replicator import SnapshotStore as TS
    from paddle_tpu_torch.serving import ServingEngine

    jm, tm = pair
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    rids, mine, fo, replayed = _fleet_with_death(tfleet, tjournal, tm, tmp_path / "t", (TS, TC))
    jrids, theirs, jfo, _ = _fleet_with_death(jfleet, jjournal, jm, tmp_path / "j", (JS, JC))
    assert fo == jfo == 1 and replayed >= 1
    eng = ServingEngine(tm, **KW)
    solo = {eng.submit(p, max_new_tokens=MAX_NEW): p for p in _prompts()}
    outs = eng.run()
    # exactly once: TokenSink.collect raises on a duplicate or a gap
    assert rids == jrids and set(mine) == set(rids)
    for rid, erid in zip(rids, solo):
        assert mine[rid] == theirs[rid] == [int(t) for t in outs[erid]], rid


# ---------------------------------------------------------------------------
# launch --mode serve on the CPU
# ---------------------------------------------------------------------------
REPLICA = textwrap.dedent("""
    import os, sys
    import torch
    torch.set_num_threads(1)
    import paddle_tpu_torch as paddle
    paddle.set_device("cpu")
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
    from paddle_tpu_torch.serving.fleet import run_replica

    work, collector = sys.argv[1], sys.argv[2]
    # the frontend outside the pod finds the launcher's fleet store here
    with open(os.path.join(work, "fleet_store.addr"), "w") as f:
        f.write(os.environ["PADDLE_TPU_FLEET_STORE"])
    cfg = llama_tiny(num_hidden_layers=2, vocab_size=96, max_position_embeddings=128)
    run_replica(LlamaForCausalLM(cfg, device="cpu"), collector_addr=collector,
                journal_root=os.path.join(work, "journals"),
                engine_kw=dict(max_batch=2, page_tokens=8, num_pages=24,
                               max_pages_per_seq=6, max_queue=4))
""")


class _LateFrontend:
    """The token collector's target before the frontend exists (the
    frontend needs the pod's fleet store, which the pod makes)."""
    fe = None

    def emit(self, rid, idx, tok):
        self.fe.emit(rid, idx, tok)


def test_launch_serve_pod_answers_drains_and_stops(tmp_path):
    """A pod of two replica processes under ``launch --mode serve``: a
    frontend over the pod's fleet store and the depot takes 4 requests
    (token-exact against one engine), drains one replica
    (``handback_queued``), stops both; the pod exits 0 and leaves its
    merged black box and metrics roll-up."""
    from paddle_tpu_torch.distributed.checkpoint.replicator import (SnapshotClient,
                                                                    SnapshotStore)
    from paddle_tpu_torch.distributed.store import TCPStore
    from paddle_tpu_torch.serving import ServingEngine, ServingFrontend, TokenSink
    from paddle_tpu_torch.serving.fleet import RemoteReplica, TokenCollector

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "replica.py"
    script.write_text(REPLICA)
    snap = SnapshotStore(host="127.0.0.1")
    depot = SnapshotClient("127.0.0.1", snap.port)
    late = _LateFrontend()
    coll = TokenCollector(late)
    sink = TokenSink(str(tmp_path / "out.jsonl"))
    log_dir = tmp_path / "log"
    pod = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch", "--mode", "serve",
         "--nproc_per_node", "2", "--log_dir", str(log_dir), str(script),
         str(tmp_path), coll.address],
        env={**os.environ, "PYTHONPATH": repo,
             "PADDLE_TPU_SNAP_STORE": f"127.0.0.1:{snap.port}"},
        start_new_session=True, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fe = kv = None
    try:
        addr = tmp_path / "fleet_store.addr"
        deadline = time.monotonic() + 120
        while not (addr.exists() and addr.read_text().strip()):
            assert pod.poll() is None and time.monotonic() < deadline, pod.stdout.read()
            time.sleep(0.1)
        h, p = addr.read_text().strip().rsplit(":", 1)
        kv = TCPStore(h, int(p), is_master=False)
        fe = late.fe = ServingFrontend(kv, depot, sink=sink)
        while len(fe.live_replicas()) < 2 and time.monotonic() < deadline:
            fe.scan_once()
            time.sleep(0.2)
        assert sorted(fe.live_replicas()) == ["replica0", "replica1"]
        assert all(isinstance(h_, RemoteReplica) for h_ in fe.handles.values())
        rids = [fe.submit(p_, max_new_tokens=3) for p_ in _prompts()]
        fe.drain("replica0")
        assert "replica0" in fe._draining
        assert fe.wait_all(rids, timeout=120), fe.summary()
        streams = TokenSink.collect(sink.path)
        # the replicas' model: seed 0 on the CPU
        eng = ServingEngine(TorchLlama(llama_tiny(num_hidden_layers=2, vocab_size=96,
                                                  max_position_embeddings=128), device="cpu"),
                            **KW)
        solo = {eng.submit(p_, max_new_tokens=3): p_ for p_ in _prompts()}
        outs = eng.run()
        for rid, erid in zip(rids, solo):
            assert streams[rid] == [int(t) for t in outs[erid]], rid
        for h_ in list(fe.handles.values()):
            h_.stop_replica()
        out, _ = pod.communicate(timeout=120)
        assert pod.returncode == 0, out
        assert (log_dir / "blackbox_merged.json").exists()
        assert (log_dir / "metrics_rollup.json").exists()
    finally:
        if pod.poll() is None:     # the launcher and its replicas
            os.killpg(pod.pid, signal.SIGKILL)
            pod.wait()
        if fe is not None:
            fe.stop()
        if kv is not None:
            kv.close()
        coll.close()
        sink.close()
        depot.close()
        snap.close()
