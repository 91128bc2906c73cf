"""The reference's ``paddle.inference`` (``inference/__init__.py``): the
handle-based predictor over a program that ``jit.save`` wrote, and the
model-backed predictor (``Predictor.from_model``) with ``generate`` and
``generate_batch``.

    config = paddle.inference.Config(path)      # the jit.save prefix
    predictor = paddle.inference.create_predictor(config)
    inp = predictor.get_input_handle(predictor.get_input_names()[0])
    inp.copy_from_cpu(batch_np)
    predictor.run()
    out = predictor.get_output_handle(predictor.get_output_names()[0])
    result = out.copy_to_cpu()

The program is a ``torch.export`` archive bound to the device it was traced
on, and the predictor runs it there.  The reference's device knobs are
inert; here ``enable_use_gpu`` on a program saved on the CPU, or
``disable_gpu`` on one saved from the card, raises and names the
program's device instead of moving the program (ROADMAP §C).  The other
knobs (memory optimisation, MKLDNN, TensorRT, IR passes, CPU threads) are
accepted and have no effect, as in the reference.  numpy has no bfloat16,
so ``copy_to_cpu`` gives a bf16 output widened to f32 (exact).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["Config", "Predictor", "create_predictor", "PrecisionType"]


class PrecisionType:
    Float32 = "float32"
    Half = "float16"
    Bfloat16 = "bfloat16"
    Int8 = "int8"


class Config:
    """The model's path (the ``jit.save`` prefix, or its ``.pdmodel``) and
    the knobs."""

    def __init__(self, prog_file: Optional[str] = None,
                 params_file: Optional[str] = None):
        path = prog_file or ""
        for suffix in (".pdmodel", ".pdiparams"):
            if path.endswith(suffix):
                path = path[: -len(suffix)]
        self._path = path
        if params_file is not None:
            expected = path + ".pdiparams"
            if params_file != expected:
                raise ValueError(
                    f"params_file must be the prefix's sidecar "
                    f"({expected!r}); jit.save writes both files under one "
                    f"prefix, got {params_file!r}")
        self._enable_memory_optim = True
        self._device: Optional[str] = None   # None: the program's own

    def model_path(self) -> str:
        return self._path

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0,
                       precision=PrecisionType.Float32) -> None:
        """Ask for the card: the program must have been saved from it."""
        self._device = "cuda"

    def disable_gpu(self) -> None:
        """Ask for the CPU: the program must have been saved there."""
        self._device = "cpu"

    def enable_memory_optim(self, x: bool = True) -> None:
        self._enable_memory_optim = x

    def enable_mkldnn(self) -> None:
        pass

    def enable_tensorrt_engine(self, *a, **k) -> None:
        pass

    def switch_ir_optim(self, x: bool = True) -> None:
        pass

    def set_cpu_math_library_num_threads(self, n: int) -> None:
        pass


class _Handle:
    """A ZeroCopyTensor-shaped handle: ``copy_from_cpu``, ``copy_to_cpu``,
    ``shape``, ``reshape``."""

    def __init__(self, name: str):
        self.name = name
        self._data: Optional[np.ndarray] = None

    def copy_from_cpu(self, data) -> None:
        # a copy, as the reference's: the caller may reuse its buffer
        self._data = np.array(data)

    def copy_to_cpu(self) -> np.ndarray:
        if self._data is None:
            raise RuntimeError(f"handle '{self.name}' holds no data yet")
        return self._data

    def shape(self) -> List[int]:
        return [] if self._data is None else list(self._data.shape)

    def reshape(self, shape) -> None:
        if self._data is not None:
            self._data = self._data.reshape(shape)


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class Predictor:
    """Handle-based predictor over a ``jit.load``-ed program
    (``Predictor(config)``), or (``Predictor.from_model``) over a live
    causal-LM module with its KV-cache decode loop."""

    def __init__(self, config: Config):
        from ..jit import load as jit_load

        self._config = config
        self._layer = jit_load(config.model_path())
        if not callable(self._layer):
            raise ValueError(
                f"{config.model_path()!r} has no .pdmodel program (jit.save "
                f"was called without input_spec, leaving only the params "
                f"sidecar) — re-export with input_spec so the serving graph "
                f"is serialized")
        device = self._layer.device
        if config._device is not None and config._device != device.type:
            asked = "enable_use_gpu()" if config._device == "cuda" else "disable_gpu()"
            raise ValueError(
                f"Config.{asked} asks for the {config._device} but the program at "
                f"{config.model_path()!r} was saved on {device}: an exported "
                f"program runs on the device it was traced on; save it again "
                f"from a model on the {config._device}")
        n_in = len(self._layer._meta.get("inputs", ())) or 1
        self._input_names = [f"input_{i}" for i in range(n_in)]
        self._inputs: Dict[str, _Handle] = {n: _Handle(n) for n in self._input_names}
        self._outputs: Dict[str, _Handle] = {}

    @classmethod
    def from_model(cls, model) -> "Predictor":
        """Serve a live model (weights already loaded) through its
        ``generate``."""
        if getattr(model, "generate", None) is None:
            raise TypeError("Predictor serves a model with a generate() method")
        self = cls.__new__(cls)
        self._config = None
        self._layer = model
        self._input_names = ["input_0"]
        self._inputs = {n: _Handle(n) for n in self._input_names}
        self._outputs = {}
        return self

    def get_input_names(self) -> List[str]:
        return list(self._input_names)

    def get_input_handle(self, name: str) -> _Handle:
        return self._inputs[name]

    def run(self) -> None:
        """Run the program on the inputs' data; the outputs land in handles
        ``output_0``, ``output_1``, ..."""
        args = []
        for n in self._input_names:
            h = self._inputs[n]
            if h._data is None:
                raise RuntimeError(f"input '{n}' not set; call copy_from_cpu first")
            args.append(torch.from_numpy(np.ascontiguousarray(h._data)))
        out = self._layer(*args)
        outs = out if isinstance(out, (list, tuple)) else [out]
        self._outputs = {}
        for i, o in enumerate(outs):
            h = _Handle(f"output_{i}")
            h._data = _host(o) if isinstance(o, torch.Tensor) else np.asarray(o)
            self._outputs[h.name] = h

    def get_output_names(self) -> List[str]:
        return list(self._outputs)

    def get_output_handle(self, name: str) -> _Handle:
        return self._outputs[name]

    def generate(self, input_ids, **kwargs) -> Tuple[np.ndarray, np.ndarray]:
        """``model.generate`` pass-through; returns (ids, scores) as numpy."""
        ids, scores = self._layer.generate(input_ids, **kwargs)
        return ids.cpu().numpy(), scores.cpu().numpy()

    def generate_batch(self, prompts, max_batch: int = 8,
                       **kwargs) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Serve RAGGED prompts: group them into power-of-two length buckets,
        left-pad each group to its bucket (every row decodes exactly as if
        unpadded), fill partial batches up to ``max_batch`` rows with copies
        of the first, and let under-full buckets merge upward into the next
        one.  ``prompts``: 1-D int sequences.  Returns per-prompt
        ``(ids, scores)`` numpy pairs in input order."""
        arrs = [np.asarray(p, np.int32).reshape(-1) for p in prompts]
        if not arrs:
            return []
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        # cap the bucket at the position budget, like generate(bucket="pow2")
        max_new = int(kwargs.get("max_new_tokens", 64))
        cap = getattr(getattr(self._layer, "config", None),
                      "max_position_embeddings", None)
        buckets: Dict[int, List[int]] = {}
        for i, a in enumerate(arrs):
            blen = max(16, 1 << (max(len(a), 1) - 1).bit_length())
            if cap is not None:
                blen = max(min(blen, cap - max_new), len(a))
            buckets.setdefault(blen, []).append(i)
        results: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}

        def dispatch(chunk, blen):
            rows, mask = [], []
            for i in chunk:
                a = arrs[i]
                rows.append(np.concatenate([np.zeros(blen - len(a), np.int32), a]))
                mask.append(np.concatenate([np.zeros(blen - len(a), np.int32),
                                            np.ones(len(a), np.int32)]))
            while len(rows) < max_batch:  # dummy rows keep the batch full
                rows.append(rows[0])
                mask.append(mask[0])
            ids, scores = self.generate(np.stack(rows),
                                        attention_mask=np.stack(mask), **kwargs)
            for r, i in enumerate(chunk):
                results[i] = (ids[r], scores[r])

        # an under-full chunk rides up into the next bucket (its rows just
        # left-pad further), so many distinct lengths still run full batches
        order = sorted(buckets)
        pending: List[int] = []
        for j, blen in enumerate(order):
            pending.extend(buckets[blen])
            while len(pending) >= max_batch:
                dispatch(pending[:max_batch], blen)
                pending = pending[max_batch:]
            if pending and j + 1 == len(order):
                dispatch(pending, blen)
                pending = []
        return [results[i] for i in range(len(arrs))]


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)
