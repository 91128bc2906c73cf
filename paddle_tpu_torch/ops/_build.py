"""Build the hand-written Hopper kernels on first use and bind them with
ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library under
``build/paddle_tpu_torch/`` at the repository root.  The library's file
name carries a hash of its sources and flags, so an edited source is
rebuilt and a current one is loaded as it is.  :func:`build` starts one
``nvcc`` per stale source, all at once, and waits for every one of them.

Every C entry point takes its pointers and the CUDA stream last as
``void*`` and returns the ``cudaGetLastError()`` of its launch; a
non-zero code raises here.  Nothing in this module runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Sequence

import torch

__all__ = ["SOURCES", "BUILD_DIR", "build", "launch", "ptr", "sm_count"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "paddle_tpu_torch"
SOURCES = ("rms_norm", "rope", "flash_attention", "decode_attention",
           "flash_attention_bwd", "fused_ln_swiglu", "ring_flash")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[str, ctypes._CFuncPtr] = {}
_sms: Dict[int, int] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    for cand in ((cuda_home and os.path.join(cuda_home, "bin", "nvcc")),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc was not found (CUDA_HOME, PATH, /usr/local/cuda/bin): the "
        "port's CUDA kernels are compiled on first use on the machine with "
        "the card")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every stale source among ``names``, one ``nvcc`` each, all
    started together.  Returns ``{name: compiler output}`` for the sources
    compiled (the ``-Xptxas -v`` register and spill report)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stale = [n for n in names if not _target(n).exists()]
    if not stale:
        return {}
    nvcc = _nvcc()
    procs = {}
    for name in stale:
        out = _target(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(
            f"{n}.cu:\n{logs[n]}" for n in failed))
    return logs


def _library(name: str) -> ctypes.CDLL:
    with _lock:
        if name not in _libs:
            build([name])
            _libs[name] = ctypes.CDLL(str(_target(name)))
        return _libs[name]


def ptr(t: torch.Tensor | None) -> int | None:
    """A tensor's device address for a ``void*`` argument (None → NULL)."""
    return None if t is None else t.data_ptr()


def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of ``device``'s card, read once a card
    (a launcher sizes a persistent grid by it)."""
    index = torch.cuda.current_device() if device.index is None else device.index
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sms[index]


def launch(source: str, symbol: str, argtypes: Sequence, device: torch.device,
           *args) -> None:
    """Call ``symbol`` of ``source``'s library with ``args`` and the current
    stream of ``device``; raise if the launch reports a CUDA error."""
    key = f"{source}:{symbol}"
    fn = _fns.get(key)
    if fn is None:
        lib = _library(source)
        fn = getattr(lib, symbol)
        fn.argtypes = [*argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.ptt_error_string.argtypes = [ctypes.c_int]
        lib.ptt_error_string.restype = ctypes.c_char_p
        _fns[key] = fn
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        msg = _library(source).ptt_error_string(rc).decode()
        raise RuntimeError(f"{symbol}: CUDA error {rc} ({msg})")
