"""Silent-data-corruption (SDC) defense: fingerprinted steps, cross-replica
vote, suspect quarantine, pre-corruption rewind.

Every robustness layer below this one defends against *loud* failures —
crashes, hangs, NaNs, lease expiry. A defective chip that silently computes
wrong-but-finite numbers sails through all of them and poisons weeks of
pretraining. The defense is a detection → attribution → quarantine ladder
composed entirely over existing substrate:

1. **Detect** — deterministic device-side *step fingerprints*: a seeded
   sign (Rademacher) projection plus an abs-sum of (a) each grad bucket
   pre-reduce, (b) the post-allreduce global grad, and (c) the parameter
   tree. :func:`fingerprint_lanes` rides ``jit.TrainStep``'s health probe,
   so the lanes travel in the same ``[loss, ok, gnorm]`` device tensor the
   guard already resolves ``max_lag`` steps late: healthy steps add **no
   host sync**.  The host knows the vote cadence, so a step off it
   computes no lanes at all (it needs no flag on the device).
2. **Attribute** — under pure data parallelism the post-allreduce grad and
   the params are BITWISE identical across replicas (same reduction, same
   update, same order), so their fingerprints must agree to the last bit.
   Every ``PADDLE_TPU_SDC_EVERY`` steps each rank publishes its exact
   fingerprint bytes to the fleet store (``sdc/<epoch>/<step>/<rank>``);
   a strict-majority vote names the minority rank. Ties are *observed*
   (``sdc_vote`` event) but never poisoned — attribution needs a majority.
   The per-bucket pre-reduce lanes are rank-LOCAL (different data shards →
   legitimately different values) and are never voted; they localize WHICH
   bucket diverged once a rank is suspect.
3. **Confirm** — a mismatch can be a one-off bit flip (transient: a cosmic
   ray, a marginal cell) or a sticky fault (a bad ALU that will keep
   corrupting). The named minority rank re-executes the same batch
   ``PADDLE_TPU_SDC_CONFIRM`` times via ``replay_fn``: if every replay now
   agrees with the majority the event was transient (logged, not poisoned);
   any replay still disagreeing with the majority — i.e. the rank cannot
   reproduce the gang's answer, disagreeing with its own first result or
   repeating a wrong one — is a *sticky* suspect.
4. **Quarantine + rewind** — a confirmed suspect records a ledger entry
   poisoning the window back to the last fingerprint-clean snapshot
   generation (detection lags by cadence + ``max_lag``, so every
   generation inside the un-clean window is conservatively untrusted, no
   matter which rank wrote it), poisons the gang ``sdc_suspect`` via
   :mod:`..fleet.fault_domain`, and exits 101. The
   ``FleetSupervisor`` answers with an **exclude-list relaunch** (same
   topology minus the quarantined slot, fresh restart budget — distinct
   from elastic degrade) and the resume ladder's ledger filtering lands
   the gang on *pre-corruption* state.

Knobs: ``PADDLE_TPU_SDC=0`` disables; ``PADDLE_TPU_SDC_EVERY`` (default
16) is the publish/vote cadence (the device lanes are computed on vote
steps only);
``PADDLE_TPU_SDC_CONFIRM`` (default 2) replays per confirmation;
``PADDLE_TPU_SDC_MAX_LAG`` (default: the health guard's 2) late-resolve
depth; ``PADDLE_TPU_SDC_SEED`` seeds every projection;
``PADDLE_TPU_SDC_VOTE_TIMEOUT`` bounds the vote gather;
``PADDLE_TPU_SDC_VERIFY_LOAD=0`` skips checkpoint fingerprint
re-verification on load.

The lanes' arithmetic: :func:`_device_signs` is the reference's counter
hash to the bit (uint32 arithmetic done in int64 masked to 32 bits, with
the multiplies split so nothing overflows); :func:`fingerprint_pair`
works tensor by tensor in fixed chunks, so the same values in the same
order give the same digest on one device.  Across the two packages the
lanes agree within rounding only (XLA and torch reduce in different
orders); the vote is never across packages.

The host-side :func:`host_fingerprint` is the checkpoint-integrity cousin:
``save_state_dict`` fingerprints every tensor *before* serialization and
records the digests in the committed metadata; ``load_state_dict``
recomputes them after deserialization — end-to-end integrity beyond the
per-shard CRC (the CRC is computed over the serialized bytes, so
corruption BETWEEN device-get and serialization produces a self-consistent
CRC; the fingerprint pins the values themselves).  Its values are the
reference's to the bit for the same bytes, so a checkpoint crosses between
the packages: a bf16 tensor is fingerprinted over its raw bytes, as the
reference's does with a bf16 array.
"""

from __future__ import annotations

import os
import struct
import time
import zlib
from collections import Counter, deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .guard import _probe_values
from .ledger import HealthError, RewindLedger

__all__ = ["SDCPolicy", "SDCMonitor", "fingerprint_pair", "fingerprint_lanes",
           "host_fingerprint", "tree_fingerprints", "sdc_enabled",
           "verify_load_enabled", "SDC_POISON_REASON", "SDC_EXIT_CODE",
           "LANES_PER_FP"]

SDC_POISON_REASON = "sdc_suspect"
# numerically equal to health.REWIND_EXIT_CODE / elastic exit — the
# supervisor relaunches on it (with the suspect's slot excluded)
SDC_EXIT_CODE = 101
# every fingerprint is a (projection, abs_sum) pair of f32 lanes
LANES_PER_FP = 2


def sdc_enabled() -> bool:
    return os.environ.get("PADDLE_TPU_SDC", "1") not in ("0", "false")


def verify_load_enabled() -> bool:
    return os.environ.get("PADDLE_TPU_SDC_VERIFY_LOAD", "1") not in ("0", "false")


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


@dataclass
class SDCPolicy:
    """Knobs of the SDC ladder; ``seed`` also seeds the checkpoint's
    host fingerprints."""

    every: int = 16          # host-side publish/vote cadence (steps)
    confirm: int = 2         # replays per transient-vs-sticky confirmation
    max_lag: int = 2         # probe late-resolve depth (0 = synchronous)
    seed: int = 0xD5C        # seeds every projection (device and host)
    vote_timeout: float = 10.0   # bound on the vote gather (seconds)

    @classmethod
    def from_env(cls) -> "SDCPolicy":
        return cls(
            every=max(1, _env_int("PADDLE_TPU_SDC_EVERY", 16)),
            confirm=max(1, _env_int("PADDLE_TPU_SDC_CONFIRM", 2)),
            max_lag=max(0, _env_int("PADDLE_TPU_SDC_MAX_LAG", 2)),
            seed=_env_int("PADDLE_TPU_SDC_SEED", 0xD5C),
            vote_timeout=_env_float("PADDLE_TPU_SDC_VOTE_TIMEOUT", 10.0))


# -- device-side fingerprints ------------------------------------------------
#
# The projection signs are a counter-hash over the element index (a few
# integer ops per element), NOT a random stream: the signs must be
# deterministic and seed-keyed but need no cryptographic quality.  A
# single flipped mantissa bit moves the abs-sum by the element's magnitude
# delta and the projection by ±delta — two independent linear views, both
# bitwise-reproducible across identical replicas on one kind of device
# (same values, same order, same reduction shape).

_M32 = 0xFFFFFFFF
_LANE_CHUNK = 1 << 24     # elements a lane works on at once (fixed: the order is part of the digest)


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``h * c mod 2**32`` for int64 ``h`` in [0, 2**32): the constant split
    in 16-bit halves, so no product leaves int64."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash_signs(h: torch.Tensor) -> torch.Tensor:
    """The ±1 f32 signs of the hash's inputs ``h`` = (index + salt) mod 2**32
    (int64): the reference's uint32 counter hash, bit for bit."""
    h = _mul32(h, 2654435761)
    h = h ^ (h >> 15)
    h = _mul32(h, 2246822519)
    bit = (h >> 13) & 1
    return 1.0 - 2.0 * bit.to(torch.float32)


def _device_signs(n: int, salt: int, device=None, start: int = 0) -> torch.Tensor:
    """The ±1 f32 signs of elements ``start .. start + n`` of a tensor with
    this ``salt``: the reference's uint32 counter hash, bit for bit."""
    i = torch.arange(start, start + n, dtype=torch.int64, device=device)
    return _hash_signs((i + (salt & _M32)) & _M32)


# the chunk plans of a layout (the tensors' sizes, dtypes, devices, the seed
# and the chunk size): each chunk's members and, on its device, the offset
# from an element's position in the chunk to its hash input, a member each
_PLANS: Dict[Any, list] = {}


def _plan(arrays: Sequence[Any], seed: int) -> list:
    """Fixed-size chunks over the tensors in order, small tensors of one
    dtype and device sharing a chunk, a large one cut in chunks: so a
    group costs a few launches a chunk, not a few a tensor.  Cached per
    layout; built once, with one copy of its small index tensors to the
    device."""
    key = (seed, _LANE_CHUNK, tuple(None if a is None else
                                    (a.numel(), a.dtype, a.device) for a in arrays))
    plan = _PLANS.get(key)
    if plan is not None:
        return plan
    plan, cur = [], None

    def flush():
        if cur is not None and cur["members"]:
            dev = cur["device"]
            cur["deltas"] = torch.tensor(cur["deltas"], dtype=torch.int64, device=dev)
            cur["sizes"] = torch.tensor([m[2] for m in cur["members"]], dtype=torch.int64,
                                        device=dev)
            plan.append(cur)

    for i, a in enumerate(arrays):
        if a is None or a.numel() == 0:
            continue
        salt = (seed + 0x9E3779B9 * (i + 1)) & _M32
        n = a.numel()
        for off in range(0, n, _LANE_CHUNK):
            piece = min(_LANE_CHUNK, n - off)
            if cur is None or cur["dtype"] != a.dtype or cur["device"] != a.device or \
                    cur["n"] + piece > _LANE_CHUNK:
                flush()
                cur = dict(dtype=a.dtype, device=a.device, n=0, members=[], deltas=[])
            # an element at position q of the chunk is element off + q - n of a
            cur["deltas"].append(salt + off - cur["n"])
            cur["members"].append((i, off, piece))
            cur["n"] += piece
    flush()
    _PLANS[key] = plan
    return plan


@torch.no_grad()
def fingerprint_pair(arrays: Sequence[Any], seed: int):
    """One (projection, abs_sum) pair of f32 0-dim tensors over a list of
    tensors (None skipped), on their device: each tensor as f32, flat, in
    the fixed chunks of :func:`_plan`."""
    arrays = [None if a is None else torch.as_tensor(a).detach().reshape(-1) for a in arrays]
    proj = asum = None
    for chunk in _plan(arrays, seed):
        parts = [arrays[i][off:off + n] for i, off, n in chunk["members"]]
        x = (parts[0] if len(parts) == 1 else torch.cat(parts)).float()
        n = chunk["n"]
        pos = torch.arange(n, dtype=torch.int64, device=x.device)
        if len(parts) == 1:
            h = (pos + chunk["deltas"][0]) & _M32
        else:
            h = (pos + torch.repeat_interleave(chunk["deltas"], chunk["sizes"],
                                               output_size=n)) & _M32
        p, q = torch.dot(x, _hash_signs(h)), x.abs().sum()
        proj = p if proj is None else proj + p
        asum = q if asum is None else asum + q
    if proj is None:
        zero = torch.zeros((), dtype=torch.float32)
        return zero, zero.clone()
    return proj, asum


def fingerprint_lanes(groups: Sequence[Sequence[Any]], seed: int,
                      labels: Optional[Sequence[str]] = None):
    """Flat list of fingerprint lanes for the health probe: one
    (projection, abs_sum) pair per group, in group order. ``labels`` is
    only for the caller's bookkeeping (lane naming)."""
    lanes = []
    for gi, group in enumerate(groups):
        p, a = fingerprint_pair(group, seed + 0x85EBCA6B * (gi + 1))
        lanes.extend([p, a])
    return lanes


def pack_digest(lanes: Sequence[float]) -> str:
    """Exact-bytes hex of f32 lanes: bitwise equality of the floats is
    string equality of the digests (NaNs included)."""
    return np.asarray(list(lanes), dtype=np.float32).tobytes().hex()


_CHUNK = 1 << 20


def _host_array(arr) -> np.ndarray:
    """A tensor or array as numpy; a bf16 tensor as its raw bytes (what the
    reference fingerprints of a bf16 array)."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint8)
        return t.numpy()
    return np.asarray(arr)


_SIGNS = np.array([1.0, -1.0])


def _sign_bits(rng: np.random.Generator, n: int) -> np.ndarray:
    """``rng.integers(0, 2, size=n)``'s values, drawn faster: for a range
    of two, numpy's Lemire draw from each 32-bit half of the generator's
    64-bit outputs (low half first) keeps the half's top bit, so the bits
    come straight from ``random_raw``.  Leaves the generator where
    ``integers`` would for an even ``n`` (every chunk but a tensor's last).
    Checked against ``integers`` once a process (:func:`_fast_signs_ok`)."""
    raw = rng.bit_generator.random_raw((n + 1) // 2)
    return raw.view(np.uint32)[:n] >> np.uint32(31)


_FAST_SIGNS: list = []


def _fast_signs_ok() -> bool:
    if not _FAST_SIGNS:
        same = all(np.array_equal(np.random.default_rng(s).integers(0, 2, size=n),
                                  _sign_bits(np.random.default_rng(s), n))
                   for s in (0, 0xD5C, 2 ** 63 + 7) for n in (1, 64, 4099))
        _FAST_SIGNS.append(same)
    return _FAST_SIGNS[0]


def host_fingerprint(arr, seed: int = 0) -> str:
    """Deterministic fingerprint of a host array (or tensor): seeded ±1
    projection + abs-sum, accumulated in float64, packed to hex.  Chunked
    so the sign stream never materialises more than ~1M elements."""
    flat = np.ascontiguousarray(_host_array(arr)).reshape(-1)
    if flat.dtype.kind not in "fiub":
        flat = flat.view(np.uint8)
    flat = flat.astype(np.float64, copy=False)
    rng = np.random.default_rng(np.uint64(seed & 0xFFFFFFFFFFFFFFFF))
    fast = _fast_signs_ok()
    proj = 0.0
    asum = 0.0
    for off in range(0, flat.size, _CHUNK):
        chunk = flat[off:off + _CHUNK]
        if fast:
            signs = np.take(_SIGNS, _sign_bits(rng, chunk.size))
        else:
            signs = 1.0 - 2.0 * rng.integers(0, 2, size=chunk.size).astype(np.float64)
        proj += float(chunk @ signs)
        asum += float(np.abs(chunk).sum())
    return struct.pack("<dd", proj, asum).hex()


def tree_fingerprints(named: Dict[str, Any], seed: int = 0) -> Dict[str, str]:
    """Per-tensor host fingerprints over a flat {key: array} dict; each
    tensor gets its own key-derived seed so swapped payloads can't cancel."""
    return {k: host_fingerprint(v, seed ^ zlib.crc32(k.encode()))
            for k, v in named.items()}


def shard_fp_name(key: str, offset) -> str:
    """Canonical ``"key@offset"`` name of one saved shard in the
    checkpoint/snapshot fingerprint maps."""
    return f"{key}@{','.join(str(int(o)) for o in offset)}"


# -- telemetry plumbing ------------------------------------------------------

def _bump(name: str, n: float = 1.0) -> None:
    try:
        from ... import telemetry

        telemetry.bump(name, n)
    except Exception:
        pass


def _set_gauge(name: str, value) -> None:
    try:
        from ... import telemetry

        telemetry.set_gauge(name, value)
    except Exception:
        pass


def _record_event(kind: str, name: str, **data) -> None:
    try:
        from ... import telemetry

        telemetry.record_event(kind, name, **data)
    except Exception:
        pass


# -- the monitor -------------------------------------------------------------

class SDCMonitor:
    """Host-side half of the SDC ladder for one training process.

    Mirrors :class:`~.guard.HealthGuard`'s probe discipline: ``on_step``
    queues the step's probe array and resolves entries ``max_lag`` steps
    late, when the device has long finished them (free fetch, no added
    host sync). Resolved fingerprint lanes are voted at ``policy.every``
    cadence through the fleet store.

    ``domain`` is a :class:`~..fleet.fault_domain.FaultDomain` (or None
    for solo mode: no vote partner, fingerprints still anchor checkpoint
    integrity and the bench overhead measurement). ``replay_fn(step) ->
    digest-hex`` re-executes the step's batch and returns the voted
    fingerprint digest; ``None`` means confirmation cannot run and a named
    minority is conservatively treated as sticky. ``ledger`` receives the
    pre-corruption poison window on quarantine. ``on_suspect``: ``"exit"``
    (default — poison + ``SystemExit(101)``), ``"raise"``
    (:class:`HealthError`), or a callable receiving the suspect doc.

    usage::

        mon = SDCMonitor(domain=fd, ledger=guard.ledger,
                         replay_fn=lambda step: replay_digest(step))
        step = TrainStep(model, loss_fn, opt, health_guard=guard)
        step.attach_sdc_monitor(mon)       # before the first guarded call
    """

    # probe slots 0..2 belong to the health guard ([loss, ok, gnorm])
    LANE_OFFSET = 3

    def __init__(self, policy: Optional[SDCPolicy] = None, *,
                 domain: Any = None,
                 ledger: Optional[RewindLedger] = None,
                 rank: Optional[int] = None,
                 world_size: Optional[int] = None,
                 replay_fn: Optional[Callable[[int], str]] = None,
                 on_suspect: Union[str, Callable[[dict], None]] = "exit",
                 name: str = "train"):
        self.policy = policy or SDCPolicy.from_env()
        self.domain = domain
        self.rank = int(rank) if rank is not None else \
            int(getattr(domain, "rank", 0) or 0)
        self.world_size = int(world_size) if world_size is not None else \
            int(getattr(domain, "world_size", 1) or 1)
        self.epoch = int(getattr(domain, "epoch", 0) or 0)
        self._kv = getattr(domain, "_kv", None)
        self.ledger = ledger
        self.replay_fn = replay_fn
        self.on_suspect = on_suspect
        self.name = name
        self.active = sdc_enabled()
        # lane layout, fixed at trace time by TrainStep: the last two
        # fingerprint pairs (global grad, param tree) are the bitwise-
        # comparable voted digest; any earlier pairs are rank-local
        # per-bucket diagnostics
        self.lane_labels: List[str] = ["grad", "params"]
        # counters (tests / telemetry / post-mortems)
        self.checks = 0
        self.mismatches = 0
        self.suspects = 0
        self.transients = 0
        self.votes_incomplete = 0
        self.last_clean_step = 0
        self.last_vote: Optional[Dict[str, Any]] = None
        self._ckpt_steps: List[int] = [0]
        self._pending: deque = deque()   # (step, device probe array)
        self._last_step = 0

    # -- wiring (TrainStep) ------------------------------------------------
    def set_lane_labels(self, labels: Sequence[str]) -> None:
        """TrainStep records the lane layout of its probe (one label per
        fingerprint pair, voted pairs last)."""
        self.lane_labels = list(labels)

    def trace_signature(self) -> Dict[str, Any]:
        """The lane layout and seed (the reference folds it into its
        compiled step's cache key; here it names the layout for a
        post-mortem)."""
        return {"seed": int(self.policy.seed),
                "labels": list(self.lane_labels)}

    # -- lifecycle hooks ---------------------------------------------------
    def note_checkpoint(self, step: int) -> None:
        """A snapshot/checkpoint generation committed at ``step``: it is a
        rewind candidate once the vote certifies a clean step at/after it."""
        self._ckpt_steps.append(int(step))

    def clean_anchor(self) -> int:
        """Newest committed generation not newer than the last fingerprint-
        clean step — the pre-corruption resume point. Generations inside
        the detection-lag window are conservatively untrusted regardless
        of which rank wrote them."""
        ok = [c for c in self._ckpt_steps if c <= self.last_clean_step]
        return max(ok) if ok else 0

    # -- device-probe path (TrainStep) -------------------------------------
    def on_step(self, probe, step: Optional[int] = None) -> None:
        """Feed one guarded step's probe (a device tensor ``[loss, ok,
        gnorm, *sdc_lanes]``, or the :class:`~.guard.HostProbe` the guard
        shares). Same ``max_lag``-late resolution as the health guard: by
        the time a probe is fetched the device finished it."""
        if not self.active:
            return
        s = int(step) if step is not None else self._last_step + 1
        if s <= self._last_step:
            s = self._last_step + 1
        self._last_step = s
        self._pending.append((s, probe))
        while len(self._pending) > max(0, self.policy.max_lag):
            ps, pr = self._pending.popleft()
            self._resolve(ps, pr)

    def flush(self) -> None:
        """Resolve every pending probe now (tests / end of epoch)."""
        while self._pending:
            ps, pr = self._pending.popleft()
            self._resolve(ps, pr)

    def _resolve(self, step: int, probe) -> None:
        vals = _probe_values(probe)  # host fetch; step long done
        lanes = np.asarray(vals[self.LANE_OFFSET:], dtype=np.float32)
        if lanes.size < 2 * LANES_PER_FP:
            return  # probe carries no voted fingerprint pairs
        self.observe(step, lanes)

    # -- vote --------------------------------------------------------------
    def observe(self, step: int, lanes: np.ndarray) -> None:
        """One resolved step's fingerprint lanes. Publishes + votes at
        cadence; off-cadence steps only feed the counters."""
        self.checks += 1
        _bump("sdc_checks_total")
        if step % max(1, self.policy.every):
            return
        voted = np.asarray(lanes[-2 * LANES_PER_FP:], dtype=np.float32)
        digest = pack_digest(voted)
        bucket_lanes = [float(x) for x in lanes[:-2 * LANES_PER_FP]]
        if self._kv is None or self.world_size <= 1:
            # solo mode: nothing to compare against — the step is clean by
            # definition of this ladder (checkpoint fingerprints still
            # verify end-to-end integrity)
            self.last_clean_step = int(step)
            _set_gauge("sdc_last_clean_step", self.last_clean_step)
            return
        self._kv.put(self._vote_key(step, self.rank), digest)
        votes = self._gather(step)
        if votes is None:
            self.votes_incomplete += 1
            _record_event("sdc_vote", self.name, step=step, rank=self.rank,
                          complete=False, timeout=self.policy.vote_timeout)
            return
        self._tally(step, digest, votes, bucket_lanes)

    def _vote_key(self, step: int, rank: int) -> str:
        return f"sdc/{self.epoch}/{int(step)}/{int(rank)}"

    def _gather(self, step: int) -> Optional[Dict[int, str]]:
        """Poll the store until every rank's digest for ``step`` is
        present, or the vote timeout lapses (a hung rank is the watchdog's
        problem, not ours — an incomplete vote is observed, never judged)."""
        deadline = time.monotonic() + max(0.1, self.policy.vote_timeout)
        votes: Dict[int, str] = {}
        while True:
            for r in range(self.world_size):
                if r in votes:
                    continue
                v = self._kv.get(self._vote_key(step, r))
                if v is not None:
                    votes[r] = str(v)
            if len(votes) == self.world_size:
                return votes
            if time.monotonic() >= deadline:
                return None
            time.sleep(0.02)

    def _tally(self, step: int, mine: str, votes: Dict[int, str],
               bucket_lanes: List[float]) -> None:
        tally = Counter(votes.values())
        groups = {d: sorted(r for r, v in votes.items() if v == d)
                  for d in tally}
        self.last_vote = {"step": int(step), "groups": groups}
        if len(tally) == 1:
            self.last_clean_step = int(step)
            _set_gauge("sdc_last_clean_step", self.last_clean_step)
            return
        self.mismatches += 1
        _bump("sdc_mismatch_total")
        top, top_n = tally.most_common(1)[0]
        majority = top if top_n > self.world_size // 2 else None
        minority = [] if majority is None else \
            sorted(r for r, v in votes.items() if v != majority)
        _record_event("sdc_vote", self.name, step=step, rank=self.rank,
                      complete=True, tie=majority is None,
                      groups={d[:16]: rs for d, rs in groups.items()},
                      minority=minority)
        if majority is None:
            return  # tie: observed, not poisoned — no attribution possible
        if self.rank in minority:
            self._confirm(step, mine, majority, bucket_lanes)

    # -- confirm + quarantine ----------------------------------------------
    def _confirm(self, step: int, mine: str, majority: str,
                 bucket_lanes: List[float]) -> None:
        """The vote named THIS rank. Re-execute the batch ``confirm``
        times: transient iff every replay reproduces the majority answer."""
        replays: List[str] = []
        if self.replay_fn is not None:
            for _ in range(max(1, self.policy.confirm)):
                try:
                    replays.append(str(self.replay_fn(step)))
                except Exception as e:
                    replays.append(f"replay_error:{e!r}"[:200])
                    break
        transient = bool(replays) and all(r == majority for r in replays)
        _record_event("sdc_confirm", self.name, step=step, rank=self.rank,
                      replays=len(replays), transient=transient,
                      confirmed_sticky=not transient)
        if transient:
            self.transients += 1
            _record_event("sdc_transient", self.name, step=step,
                          rank=self.rank, first=mine[:16],
                          majority=majority[:16])
            return
        self._quarantine(step, mine, majority, replays, bucket_lanes)

    def _quarantine(self, step: int, mine: str, majority: str,
                    replays: List[str], bucket_lanes: List[float]) -> None:
        self.suspects += 1
        _bump("sdc_suspects_total")
        anchor = self.clean_anchor()
        entry: Dict[str, Any] = {"window": [anchor, int(step)]}
        if self.ledger is not None:
            entry = self.ledger.record(
                step=int(step), resume_step=anchor, reason="sdc",
                culprit=self.rank, last_clean_step=self.last_clean_step,
                mine=mine, majority=majority)
        doc = {"reason": SDC_POISON_REASON, "step": int(step),
               "rank": self.rank, "resume_step": anchor,
               "window": entry.get("window"),
               "last_clean_step": self.last_clean_step,
               "replays": replays, "bucket_lanes": bucket_lanes}
        _record_event("sdc_suspect", self.name, **doc)
        try:
            from ... import telemetry

            telemetry.dump_flight_recorder(reason="sdc_suspect")
        except Exception:
            pass
        if callable(self.on_suspect):
            self.on_suspect(doc)
            return
        if self.on_suspect == "raise":
            raise HealthError(
                f"SDC suspect confirmed sticky at step {step} on rank "
                f"{self.rank}: fingerprint {mine[:16]}… disagrees with the "
                f"gang majority {majority[:16]}… and "
                f"{len(replays)} replay(s) could not reproduce the "
                f"majority; poisoned window {doc['window']}")
        if self.domain is not None:
            try:
                self.domain.poison(
                    SDC_POISON_REASON, culprit=self.rank,
                    detail=f"step {step}: sticky fingerprint mismatch "
                           f"({mine[:16]}… vs majority {majority[:16]}…), "
                           f"rewind to {anchor}")
            except Exception:
                pass
        raise SystemExit(SDC_EXIT_CODE)
