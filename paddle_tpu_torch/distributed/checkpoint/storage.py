"""Retriable checkpoint I/O (port of the reference's
``distributed/checkpoint/storage.py``).

All shard/metadata bytes flow through :func:`write_bytes` / :func:`read_bytes`
so that (a) transient storage failures — disk-full races, NFS/GCS flake —
are absorbed by :func:`retry_io`'s exponential backoff + jitter instead of
killing a multi-hour run, and (b) the fault injector (``faults.py``) has a
single seam to break: every call announces itself via ``faults.fire(op,
path, data)`` *inside* the retry loop, so an injected ``times=2`` flake
exercises the real backoff path.

Writes are individually atomic (``.part`` + ``os.replace``) so a crash
mid-write can never leave a half-written file at the final path — the only
torn-file source is the injector's explicit ``truncate`` mode, which
bypasses the rename on purpose to model a kill inside ``write(2)``.

Retry policy: ``attempts`` (env ``PADDLE_TPU_CKPT_RETRIES``, default 3),
delay ``base * 2**attempt`` capped at ``max_delay``, multiplied by a random
jitter in ``[1, 1+jitter]`` to de-synchronize ranks hammering the same
filesystem. Only ``OSError`` retries; injected crashes and programming
errors propagate immediately.
"""

from __future__ import annotations

import os
import random
import zlib
from typing import Callable, Optional, TypeVar

from . import faults
from ..retry import BackoffPolicy, retry_call

__all__ = ["retry_io", "write_bytes", "read_bytes", "crc32"]

T = TypeVar("T")

_DEFAULT_ATTEMPTS = 3


def _attempts() -> int:
    try:
        n = int(os.environ.get("PADDLE_TPU_CKPT_RETRIES", _DEFAULT_ATTEMPTS))
    except ValueError:
        n = _DEFAULT_ATTEMPTS
    return max(1, n)


def retry_io(fn: Callable[[], T], *, attempts: Optional[int] = None,
             base_delay: float = 0.05, max_delay: float = 2.0,
             jitter: float = 0.5, rng: Optional[random.Random] = None,
             describe: str = "checkpoint io") -> T:
    """Run ``fn`` with exponential backoff + jitter on ``OSError``.

    A thin wrapper over the shared :mod:`..retry` engine: same delay
    sequence as the historical inline loop (``base * 2**attempt`` capped,
    jitter drawn from the caller's ``rng``), ``FileNotFoundError``
    propagates immediately (a missing file is a protocol error, not
    storage flake), and every absorbed flake still lands in the flight
    recorder as a ``checkpoint_io_retry`` event.
    """
    attempts = _attempts() if attempts is None else max(1, attempts)

    def _note(attempt: int, exc: BaseException, backoff_s: float) -> None:
        # flight recorder: flakes that retries absorbed still show
        from ... import telemetry

        telemetry.record_event("checkpoint_io_retry", describe, attempt=attempt + 1,
                               error=repr(exc)[:200], backoff_s=round(backoff_s, 4))

    return retry_call(
        fn, attempts=attempts,
        policy=BackoffPolicy(base=base_delay, cap=max_delay, jitter=jitter),
        retry_on=(OSError,), raise_now=(FileNotFoundError,),
        on_retry=_note, rng=rng or random)


def write_bytes(path: str, data: bytes, *, op: str = "write",
                attempts: Optional[int] = None) -> int:
    """Atomically write ``data`` to ``path`` (tmp + rename), with retries.
    Returns the CRC32 of ``data`` so callers record it for free."""

    def _once():
        faults.fire(op, path, data)
        tmp = path + ".part"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    retry_io(_once, attempts=attempts, describe=os.path.basename(path))
    return zlib.crc32(data) & 0xFFFFFFFF


def read_bytes(path: str, *, op: str = "read",
               attempts: Optional[int] = None) -> bytes:
    """Read ``path`` fully, with retries on transient errors."""

    def _once():
        faults.fire(op, path)
        with open(path, "rb") as f:
            return f.read()

    return retry_io(_once, attempts=attempts, describe=os.path.basename(path))


def crc32(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF
