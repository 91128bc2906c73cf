"""The chip tables and the collective registry's read side (the part of
the reference's ``telemetry/collectives.py`` that ``StepMeter`` reads).

``PEAK_TFLOPS`` (dense bf16 TFLOP/s) and ``PEAK_HBM_GBPS`` (device memory
GB/s) keep the reference's TPU rows and its nominal CPU row, and add the
H100's: the SXM card at 989 TFLOP/s and 3350 GB/s, the PCIe card at 756
and 2000, the PCIe row first so that its name does not match the SXM row.
:func:`chip_lookup` matches substrings of a device's name
(``torch.cuda.get_device_name``) against a table.

:func:`collective_stats` reads the per-kind registry of executed
collectives.  Nothing feeds it yet: the recording side (``record_collective``
from ``distributed/communication.py``, the traced programs, the ICI cost
model) arrives with the rest of telemetry (ROADMAP A8), so it returns an
empty dict until then.
"""

from __future__ import annotations

import threading
from typing import Dict

import torch

from . import runtime

__all__ = ["collective_stats", "PEAK_TFLOPS", "PEAK_HBM_GBPS", "chip_lookup"]

# chip kind -> peak dense bf16 TFLOP/s
PEAK_TFLOPS = {
    "h100 pcie": 756.0, "h100": 989.0,
    "v5 lite": 197.0, "v5e": 197.0, "v5litepod": 197.0,
    "v5p": 459.0, "v4": 275.0, "v6e": 918.0, "v6": 918.0,
    "cpu": 0.5,  # nominal, so CPU smoke runs still report
}

# chip kind -> peak device-memory bandwidth GB/s
PEAK_HBM_GBPS = {
    "h100 pcie": 2000.0, "h100": 3350.0,
    "v5 lite": 819.0, "v5e": 819.0, "v5litepod": 819.0,
    "v5p": 2765.0, "v4": 1228.0, "v6e": 1640.0, "v6": 1640.0,
    "cpu": 50.0,
}


def _device_kind(device) -> str:
    """The name of ``device``: a card's from ``torch.cuda.get_device_name``;
    a string that names no device type is taken as the name itself."""
    if isinstance(device, str) and device.split(":")[0] not in ("cuda", "cpu", "gpu"):
        return device
    dev = torch.device(device.replace("gpu", "cuda") if isinstance(device, str) else device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def chip_lookup(device, table: dict) -> float:
    """The first row of ``table`` whose key is a substring of the device's
    lower-cased name; the ``"cpu"`` row if none is."""
    kind = _device_kind(device).lower()
    for key, val in table.items():
        if key in kind:
            return val
    return table["cpu"]


_aggs: Dict[str, dict] = {}
_agg_lock = threading.Lock()


def collective_stats() -> Dict[str, dict]:
    """Per-kind {calls, trace_records, bytes, wire_bytes, ici_est_s} of the
    recorded collectives (none are recorded before ROADMAP A8)."""
    with _agg_lock:
        return {k: dict(v) for k, v in _aggs.items()}


def _reset() -> None:
    with _agg_lock:
        _aggs.clear()


runtime.on_reset(_reset)
