"""Per-card memory watermarks from ``torch.cuda.memory_stats`` (port of
the reference's ``telemetry/memory.py``, which reads PJRT's).

The caching allocator of each visible card gives live and peak bytes
(``allocated_bytes.all.current`` / ``.peak``, what
``torch.cuda.memory_allocated`` and ``max_memory_allocated`` read) and the
card's capacity is its limit.  Without a card, or before CUDA is
initialised, every function returns what the reference returns on a
backend without counters: an empty list, zeros, ``devices`` 0.
"""

from __future__ import annotations

from typing import List

import torch

__all__ = ["hbm_stats", "hbm_watermarks", "hbm_peak_gb"]


def hbm_stats() -> List[dict]:
    """One dict per visible card: {device, platform, kind, bytes_in_use,
    peak_bytes_in_use, bytes_limit}; empty without a card."""
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return []
    out = []
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out.append({
            "device": i,
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(i),
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(torch.cuda.get_device_properties(i).total_memory),
        })
    return out


def hbm_watermarks() -> dict:
    """Worst-card watermarks in GB (1e9 bytes): {live_gb, peak_gb,
    limit_gb, devices}.  All zeros with devices=0 without a card."""
    stats = hbm_stats()
    if not stats:
        return {"live_gb": 0.0, "peak_gb": 0.0, "limit_gb": 0.0, "devices": 0}
    return {
        "live_gb": round(max(s["bytes_in_use"] for s in stats) / 1e9, 4),
        "peak_gb": round(max(s["peak_bytes_in_use"] for s in stats) / 1e9, 4),
        "limit_gb": round(max(s["bytes_limit"] for s in stats) / 1e9, 4),
        "devices": len(stats),
    }


def hbm_peak_gb() -> float:
    return hbm_watermarks()["peak_gb"]
