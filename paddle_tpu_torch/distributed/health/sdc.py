"""Silent-data-corruption fingerprints, host half (port of the reference's
``distributed/health/sdc.py:85-230``).

What the checkpoint needs: :func:`host_fingerprint`, a seeded ±1
projection and an abs-sum of a host array's values, accumulated in float64
and packed to hex, which ``save_state_dict`` records for every shard before
serialisation and ``load_state_dict`` checks after it (and the snapshots
likewise); :func:`tree_fingerprints` over a flat dict with a key-derived
seed each; :func:`shard_fp_name`; :func:`pack_digest`; the knobs
(:class:`SDCPolicy`, ``PADDLE_TPU_SDC``, ``PADDLE_TPU_SDC_VERIFY_LOAD``).
The fingerprints are the reference's to the bit for the same bytes, so a
checkpoint crosses between the packages: a bf16 tensor is fingerprinted
over its raw bytes, as the reference's does with a bf16 array (its dtype
kind is not one of ``"fiub"``).

The device lanes (``fingerprint_pair``, ``fingerprint_lanes``) and the
cross-replica vote (:class:`SDCMonitor`) wait for ROADMAP A7b (the SDC
monitor) and raise.
"""

from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

__all__ = ["SDCPolicy", "SDCMonitor", "fingerprint_lanes",
           "host_fingerprint", "tree_fingerprints", "sdc_enabled",
           "verify_load_enabled", "SDC_POISON_REASON", "SDC_EXIT_CODE",
           "LANES_PER_FP"]

SDC_POISON_REASON = "sdc_suspect"
# numerically equal to the elastic exit code
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


def _waits_a7b(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"health.sdc {what}: the device fingerprint lanes and the cross-replica "
        f"vote are not ported yet (ROADMAP A7b: the SDC monitor)")


def fingerprint_pair(arrays: Sequence[Any], seed: int):
    raise _waits_a7b("fingerprint_pair")


def fingerprint_lanes(groups: Sequence[Sequence[Any]], seed: int,
                      labels: Optional[Sequence[str]] = None):
    raise _waits_a7b("fingerprint_lanes")


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


class SDCMonitor:
    """The cross-replica vote and quarantine: waits for ROADMAP A7b."""

    def __init__(self, policy: Optional[SDCPolicy] = None, *,
                 domain: Any = None,
                 ledger: Any = None,
                 rank: Optional[int] = None,
                 world_size: Optional[int] = None,
                 replay_fn: Optional[Callable[[int], str]] = None,
                 on_suspect: Union[str, Callable[[dict], None]] = "exit",
                 name: str = "train"):
        raise _waits_a7b("SDCMonitor")
