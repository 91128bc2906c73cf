"""Retriable, atomic file I/O (port of ``write_bytes``, ``read_bytes`` and
``retry_io`` of the reference's ``distributed/checkpoint/storage.py``).

A write goes to ``<path>.part``, is flushed and ``fsync``-ed, then renamed
over ``path``, so a crash mid-write never leaves a half-written file at the
final path.  A transient ``OSError`` is retried ``PADDLE_TPU_CKPT_RETRIES``
times in all (default 3), after a delay of ``base * 2**attempt`` capped at
``max_delay`` and stretched by a random jitter in ``[1, 1 + jitter]``;
``FileNotFoundError`` propagates at once (a missing file is a protocol
error, not a flake).  The reference's fault injector announces every call
(``op=``) inside the retry loop: here ``op`` is accepted and unused until
the chaos seams are ported (ROADMAP A7).
"""

from __future__ import annotations

import os
import random
import time
import zlib
from typing import Callable, Optional, TypeVar

__all__ = ["retry_io", "write_bytes", "read_bytes"]

T = TypeVar("T")


def _attempts() -> int:
    try:
        n = int(os.environ.get("PADDLE_TPU_CKPT_RETRIES", "3"))
    except ValueError:
        n = 3
    return max(1, n)


def retry_io(fn: Callable[[], T], *, attempts: Optional[int] = None,
             base_delay: float = 0.05, max_delay: float = 2.0,
             jitter: float = 0.5) -> T:
    """Call ``fn``, retrying an ``OSError`` with exponential backoff; the
    last failure propagates."""
    attempts = _attempts() if attempts is None else max(1, attempts)
    for attempt in range(attempts):
        try:
            return fn()
        except FileNotFoundError:
            raise
        except OSError:
            if attempt == attempts - 1:
                raise
            time.sleep(min(max_delay, base_delay * 2 ** attempt)
                       * (1.0 + jitter * random.random()))
    raise AssertionError("unreachable")


def write_bytes(path: str, data: bytes, *, op: str = "write",
                attempts: Optional[int] = None) -> int:
    """Atomically write ``data`` to ``path`` (tmp + fsync + rename), with
    retries.  Returns the CRC32 of ``data``."""

    def _once():
        tmp = path + ".part"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    retry_io(_once, attempts=attempts)
    return zlib.crc32(data) & 0xFFFFFFFF


def read_bytes(path: str, *, op: str = "read",
               attempts: Optional[int] = None) -> bytes:
    """Read ``path`` whole, with retries on transient errors."""

    def _once():
        with open(path, "rb") as f:
            return f.read()

    return retry_io(_once, attempts=attempts)
