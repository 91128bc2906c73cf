"""``to_static``, ``jit.save``/``jit.load`` and the training step (port of
the reference's ``jit/__init__.py``).

``to_static`` (:class:`StaticFunction`) keeps the reference's contract and
runs eagerly: it finds the layers whose state the function touches (the
bound layer, closures, defaults and the globals the code loads), keys a
bounded cache by the call's structure, shapes, dtypes and static leaves,
and calls the function, so gradients reach parameters and inputs and
buffers update in place, as the reference's compiled program does.  It
compiles nothing: ``torch.compile`` would put compile time on every new
shape, and the hand kernels are already what the forward runs.

``save`` writes ``<path>.pdiparams`` (the state dict, ``framework.io``'s
format, which both packages read) and, given ``input_spec``, the inference
forward as a ``torch.export`` archive, ``<path>.pdmodel``, where the
reference writes serialised StableHLO.  Parameters are frozen into the
archive.  While it traces, the kernel seam routes each flag-on op to its
``paddle_tpu_torch::`` operator (``ops.custom_ops``), so the saved graph
holds B1, B2 and B3 as nodes that launch the kernels when the program
runs on the card.  A dynamic ``InputSpec`` dimension (``None``, ``-1`` or a
name) becomes a ``torch.export.Dim`` by the reference's rule: a name is one
symbol across the specs, anonymous dimension 0 is the shared batch, and
other anonymous dimensions vary on their own.  A program is bound to the
device it was traced on, which ``save`` records in the archive; ``load``
gives a :class:`TranslatedLayer` that runs it there.  A ``.pdmodel`` of the
reference (serialised StableHLO) is refused with the format named.

:class:`TrainStep`: the reference compiles gradients, clipping and the
update into one XLA program with donated state.  PyTorch runs eagerly, so
the port's step is the same sequence in eager code: clear the gradients,
``loss_fn(model, *batch)``, ``backward``, clip, update.  The numbers follow
the reference: the reference differentiates with respect to the f32 master
weights, so a bf16 parameter's gradient is its bf16 cotangent cast to f32,
which is what the optimizer does with ``.grad`` before the clip.
``gradient_merge=k`` splits every batch argument into k micro-batches
along dim 0, sums their gradients in f32, and divides by k (the
reference's default averaging; ``optimizer._gradient_merge_avg`` False,
which ``fleet`` sets from its strategy, keeps the sum); the loss returned
is the mean of the micro-batch losses.  Without ``gradient_merge``, k
comes from ``optimizer._gradient_merge_k`` (set by
``fleet.distributed_optimizer``), as in the reference.

``donate`` is accepted and has no effect: the reference donates the state
buffers to its compiled step, and the eager step updates them in place
anyway.  A model with an ``apply_collective_grads`` method (a
``distributed.DataParallel``) has its gradients synchronised after each
(micro-batch) backward and before the clip and update: across processes,
the mean over the data-parallel group, which the reference's compiled step
gets from XLA's gradient all-reduce over a batch sharded on ``data``.
``snapshotter=`` (a ``distributed.checkpoint.Snapshotter``) copies the
state into host memory at its cadence after the update.

The reference's ``health_guard`` and SDC monitor wait for ROADMAP A7b and
raise.  ``persistent_cache`` keeps compiled XLA programs across processes;
an eager step compiles no program, so it raises too, naming the compile
service (ROADMAP A10).
"""

from __future__ import annotations

import collections
import dis
import functools
import json
import os
import zipfile
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..nn.clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue  # noqa: F401

__all__ = ["to_static", "TrainStep", "not_to_static", "ignore_module", "save",
           "load", "InputSpec", "TranslatedLayer"]


class _CompileCache:
    """Bounded cache (LRU) keyed as the reference's compile cache, capped
    at ``PADDLE_TPU_JIT_CACHE_MAX`` entries (default 64); an eviction
    bumps the ``compile_cache_evictions`` counter.  ``persistent`` is kept
    for the reference's signature; the eager port has no program to keep
    on disk."""

    _DEFAULT_MAX = 64

    def __init__(self, max_entries: Optional[int] = None, persistent=None):
        if max_entries is None:
            try:
                max_entries = int(os.environ.get("PADDLE_TPU_JIT_CACHE_MAX",
                                                 self._DEFAULT_MAX))
            except ValueError:
                max_entries = self._DEFAULT_MAX
        self.max_entries = max(1, max_entries)
        self.persistent = persistent
        self.evictions = 0
        self._entries: "collections.OrderedDict[Any, Any]" = collections.OrderedDict()

    def get(self, key, default=None):
        try:
            value = self._entries[key]
        except KeyError:
            return default
        self._entries.move_to_end(key)
        return value

    def put(self, key, value) -> None:
        self._entries[key] = value
        self._entries.move_to_end(key)
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)
            self.evictions += 1
            from .. import telemetry

            telemetry.bump("compile_cache_evictions")

    __setitem__ = put

    def __getitem__(self, key):
        value = self.get(key, default=_MISSING)
        if value is _MISSING:
            raise KeyError(key)
        return value

    def __contains__(self, key) -> bool:
        return key in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        self._entries.clear()


_MISSING = object()


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


class StaticFunction:
    """``to_static``'s callable: one cache entry per (input structure,
    shapes, dtypes, static leaves, state counts), and an eager call."""

    def __init__(self, fn: Callable, layer: Optional[torch.nn.Module] = None,
                 input_spec=None, full_graph: bool = True, backend=None):
        self._fn = fn
        self._layer = layer
        self._cache = _CompileCache()
        try:
            functools.update_wrapper(self, fn)
        except (AttributeError, TypeError):
            pass

    def _discover_layers(self) -> List[torch.nn.Module]:
        """The layers whose state the function touches: the bound layer,
        any layer in its closure or defaults, and any layer its code loads
        as a global (``LOAD_GLOBAL``/``LOAD_NAME``; attribute names are not
        followed, as in the reference)."""
        layers = [] if self._layer is None else [self._layer]
        for cell in getattr(self._fn, "__closure__", None) or ():
            try:
                v = cell.cell_contents
            except ValueError:
                continue
            if isinstance(v, torch.nn.Module):
                layers.append(v)
        layers += [v for v in getattr(self._fn, "__defaults__", None) or ()
                   if isinstance(v, torch.nn.Module)]
        code = getattr(self._fn, "__code__", None)
        fglobals = getattr(self._fn, "__globals__", None)
        if code is not None and fglobals is not None:
            for ins in dis.get_instructions(code):
                if ins.opname in ("LOAD_GLOBAL", "LOAD_NAME"):
                    v = fglobals.get(ins.argval)
                    if isinstance(v, torch.nn.Module):
                        layers.append(v)
        return layers

    def _state(self):
        params, buffers, seen = [], [], set()
        for layer in self._discover_layers():
            for p in layer.parameters():
                if id(p) not in seen:
                    seen.add(id(p))
                    params.append(p)
            for b in layer.buffers():
                if id(b) not in seen:
                    seen.add(id(b))
                    buffers.append(b)
        return params, buffers

    def __call__(self, *args, **kwargs):
        params, buffers = self._state()
        leaves, treedef = pytree.tree_flatten((args, kwargs))
        mask = tuple(_is_tensor(l) for l in leaves)
        key = (treedef, mask,
               tuple(repr(l) for l, m in zip(leaves, mask) if not m),
               tuple((tuple(l.shape), str(l.dtype)) for l, m in zip(leaves, mask) if m),
               len(params), len(buffers))
        if self._cache.get(key) is None:
            self._cache[key] = {"shapes": key[3]}
        return self._fn(*args, **kwargs)


def to_static(function=None, input_spec=None, build_strategy=None, backend=None,
              full_graph: bool = True, **kwargs):
    """A layer (its ``forward`` replaced) or a function as a
    :class:`StaticFunction`; usable as a decorator with or without
    arguments."""

    def decorate(fn):
        if isinstance(fn, torch.nn.Module):
            fn.forward = StaticFunction(fn.forward, layer=fn, input_spec=input_spec)
            return fn
        layer = getattr(fn, "__self__", None)
        return StaticFunction(fn, layer=layer if isinstance(layer, torch.nn.Module)
                              else None, input_spec=input_spec)

    if function is not None:
        return decorate(function)
    return decorate


def not_to_static(fn):
    fn._not_to_static = True
    return fn


def ignore_module(modules):
    pass


class TrainStep:
    """``step = TrainStep(model, lambda m, x, y: m(x, labels=y)[0], opt)``;
    ``loss = step(x, y)`` updates the model and optimizer in place and
    returns the loss, an f32 scalar tensor on the model's device.  Batch
    arguments may be tensors or numpy arrays; they are moved to the
    model's device."""

    def __init__(self, model: torch.nn.Module, loss_fn: Callable, optimizer,
                 donate: bool = True, gradient_merge: Optional[int] = None,
                 health_guard=None, persistent_cache=None, snapshotter=None):
        if health_guard is not None:
            raise NotImplementedError(
                "TrainStep health_guard= is not ported yet (ROADMAP A7b: the health guard)")
        if persistent_cache is not None:
            raise NotImplementedError(
                "TrainStep persistent_cache= caches compiled XLA programs across "
                "processes; the eager step compiles none, so it has nothing to "
                "cache (the compile service is ROADMAP A10)")
        self.model = model
        self._sync_grads = getattr(model, "apply_collective_grads", None)
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        if gradient_merge is None:
            gradient_merge = getattr(optimizer, "_gradient_merge_k", 1)
        self._merge_k = max(1, int(gradient_merge or 1))
        self._merge_avg = bool(getattr(optimizer, "_gradient_merge_avg", True))
        self._params = [p for p in model.parameters() if p.requires_grad]
        self._snapshotter = snapshotter

    def attach_health_guard(self, guard) -> None:
        raise NotImplementedError(
            "TrainStep health guard is not ported yet (ROADMAP A7b: the health guard)")

    def attach_snapshotter(self, snapshotter) -> None:
        """Arm a ``distributed.checkpoint.Snapshotter`` (as ``snapshotter=``
        does): every ``snapshotter.every``-th completed step it copies the
        just-updated state into host memory.  ``None`` detaches it."""
        self._snapshotter = snapshotter

    def attach_sdc_monitor(self, monitor) -> None:
        raise NotImplementedError(
            "TrainStep SDC monitor is not ported yet (ROADMAP A7b: the SDC monitor)")

    def _batch(self, batch) -> List[torch.Tensor]:
        device = next(iter(self.model.parameters())).device
        arrays = [torch.as_tensor(b, device=device) for b in batch]
        if self._merge_k > 1:
            for a in arrays:
                if a.dim() == 0 or a.shape[0] % self._merge_k:
                    raise ValueError(
                        f"gradient_merge k={self._merge_k} needs every batch "
                        f"arg's dim0 divisible by k, got shape {tuple(a.shape)}")
        return arrays

    def __call__(self, *batch) -> torch.Tensor:
        loss, grads = self._loss_and_grads(self._batch(batch))
        self._update(grads)
        if self._snapshotter is not None:
            # the capture copies the state the update just wrote, before the
            # next step changes it in place; a failed snapshot degrades
            # what a restart can recover and never stops the step (the
            # snapshotter counts and records it), as in the reference
            try:
                self._snapshotter.on_step(self.optimizer._step_count)
            except Exception:
                pass
        return loss

    def _loss_and_grads(self, arrays: List[torch.Tensor]):
        """The loss (an f32 scalar) and the ``[(param, grad)]`` the update
        takes: the optimizer's parameters with their ``.grad``, or, under
        gradient merge, the merged f32 gradients."""
        for p in self._params:
            p.grad = None
        k = self._merge_k
        if k == 1:
            loss = self.loss_fn(self.model, *arrays).float()
            loss.backward()
            if self._sync_grads is not None:
                self._sync_grads()
            return loss.detach(), [(p, p.grad) for p in self.optimizer._parameter_list
                                   if p.requires_grad and p.grad is not None]
        merged: Dict[int, torch.Tensor] = {}
        loss_sum = torch.zeros((), dtype=torch.float32, device=arrays[0].device)
        for i in range(k):
            micro = [a.chunk(k)[i] for a in arrays]
            loss_i = self.loss_fn(self.model, *micro).float()
            loss_i.backward()
            if self._sync_grads is not None:   # the mean over ranks is linear:
                self._sync_grads()             # synchronise each micro-batch
            loss_sum += loss_i.detach()
            for p in self._params:
                if p.grad is not None:
                    g = p.grad.float()
                    merged[id(p)] = g if id(p) not in merged else merged[id(p)] + g
                    p.grad = None
        div = k if self._merge_avg else 1
        return loss_sum / k, [(p, merged[id(p)] / div) for p in self._params
                              if id(p) in merged]

    def _update(self, grads) -> None:
        """Clip and update (the optimizer's ``_apply``), then re-apply the
        ``incubate.asp`` masks of pruned parameters, as the reference's
        step does."""
        from ..incubate.asp import ASPHelper

        self.optimizer._apply(grads)
        ASPHelper.apply_masks(self.optimizer)


class InputSpec:
    """Shape and dtype of one model input (the reference's
    ``static/input.py`` InputSpec).  ``None``/``-1`` dimensions are dynamic
    in the saved program; a ``str`` dimension names its symbol, and equal
    names share one symbol across specs; anonymous dynamic dimensions at
    position 0 share one batch symbol, other anonymous ones vary on their
    own."""

    def __init__(self, shape, dtype="float32", name=None, stop_gradient=True):
        self.shape = tuple(
            s if isinstance(s, str)
            else None if s is None or int(s) == -1 else int(s)
            for s in shape)
        self.dtype = dtype
        self.name = name

    def __repr__(self):
        return f"InputSpec(shape={self.shape}, dtype={self.dtype!r}, name={self.name!r})"


# the example size of each dynamic dimension: distinct and >= 2, since
# torch.export specialises a dimension whose example is 0 or 1 and unifies
# two dimensions whose examples are equal
_EXAMPLE_SIZES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47)
_FORMAT = "paddle_tpu_torch.pdmodel/1"
_META = "paddle_tpu_torch.json"


def _export_args(specs, device: torch.device, max_len: Optional[int]):
    """(example inputs, dynamic_shapes, spec records) for ``torch.export``.
    A dynamic dimension first seen past position 0 is capped at
    ``max_len`` (the model's position table) when the model has one: the
    eager model clips positions beyond it, and a program should not take a
    sequence its model was never built for."""
    from ..framework.dtype import convert_dtype

    fixed = {s for spec in specs if isinstance(spec, InputSpec)
             for s in spec.shape if isinstance(s, int)}
    sizes = iter(s for s in _EXAMPLE_SIZES if s not in fixed)
    dims: Dict[Any, tuple] = {}
    examples, dynamic, records = [], [], []
    for i, spec in enumerate(specs):
        if not isinstance(spec, InputSpec):
            t = torch.as_tensor(spec).to(device)
            examples.append(t)
            dynamic.append(None)
            records.append({"name": f"input_{i}", "shape": list(t.shape),
                            "dtype": str(t.dtype).replace("torch.", "")})
            continue
        shape, spec_dims = [], {}
        for j, s in enumerate(spec.shape):
            if isinstance(s, int):
                shape.append(s)
                continue
            key = s if isinstance(s, str) else "_dbatch" if j == 0 else f"_d{i}_{j}"
            if key not in dims:
                name = "".join(c if c.isalnum() else "_" for c in str(key))
                name = name if name[:1].isalpha() else f"d{name}"
                cap = None if j == 0 else max_len
                dims[key] = (torch.export.Dim(name, min=1, max=cap), next(sizes))
            spec_dims[j] = dims[key][0]
            shape.append(dims[key][1])
        dtype = convert_dtype(spec.dtype)
        examples.append(torch.zeros(shape, dtype=dtype, device=device))
        dynamic.append(spec_dims or None)
        records.append({"name": spec.name or f"input_{i}", "shape": list(spec.shape),
                        "dtype": str(dtype).replace("torch.", "")})
    return examples, dynamic, records


class _Flat(torch.nn.Module):
    """The traced forward: ``fn``'s tensor outputs as a flat tuple, as the
    reference's exported function returns them."""

    def __init__(self, fn: Callable, layer: Optional[torch.nn.Module]):
        super().__init__()
        self.layer = layer
        self._call = fn

    def forward(self, *args):
        leaves, _ = pytree.tree_flatten(self._call(*args))
        return tuple(l for l in leaves if isinstance(l, torch.Tensor))


def save(layer, path: str, input_spec=None, **configs) -> None:
    """``jit.save``: ``<path>.pdiparams``, the state dict (always), and,
    given ``input_spec``, ``<path>.pdmodel``: the inference forward
    exported by ``torch.export`` with the parameters frozen in, runnable
    by ``jit.load`` without the model's class."""
    from ..framework.io import save as _save
    from ..ops import exporting

    target = layer._fn if isinstance(layer, StaticFunction) else layer
    base = layer._layer if isinstance(layer, StaticFunction) else \
        (layer if isinstance(layer, torch.nn.Module) else None)
    if base is not None:
        _save(base.state_dict(), path + ".pdiparams")
    elif not callable(target):
        _save(target, path + ".pdiparams")
        return
    if input_spec is None:
        if base is None:
            raise ValueError(
                "jit.save of a plain function requires input_spec — there are "
                "no parameters to persist and no signature to trace a graph from")
        return  # parameters only: no graph without an input signature
    fwd = base.forward if base is not None and target is base else target
    param = next(iter(base.parameters()), None) if base is not None else None
    if param is not None:
        device = param.device
    else:
        from ..device import get_device

        device = get_device()
    max_len = None
    for mod in ([] if base is None else base.modules()):
        max_len = getattr(getattr(mod, "config", None), "max_position_embeddings", None)
        if max_len is not None:
            break
    examples, dynamic, records = _export_args(list(input_spec), device, max_len)
    was_training = base.training if base is not None else False
    if base is not None:
        base.eval()
    try:
        with torch.no_grad(), exporting():
            program = torch.export.export(_Flat(fwd, base), tuple(examples),
                                          dynamic_shapes=(tuple(dynamic),))
    finally:
        if base is not None and was_training:
            base.train()
    meta = {"format": _FORMAT, "device": str(device), "inputs": records,
            "outputs": len(program.graph_signature.user_outputs)}
    with open(path + ".pdmodel", "wb") as f:
        torch.export.save(program, f, extra_files={_META: json.dumps(meta)})


def _load_program(file: str):
    """(the exported program, its record) of a ``.pdmodel`` the port wrote."""
    with open(file, "rb") as f:
        head = f.read(4)
    if not zipfile.is_zipfile(file):
        raise ValueError(
            f"jit.load: {file!r} is not a torch.export archive (a .pt2 zip; it "
            f"begins with {head!r}): a .pdmodel of the JAX package holds "
            f"serialised StableHLO, which the port does not run; load the "
            f"parameters from the .pdiparams sidecar into the model instead")
    from ..ops import custom_ops  # noqa: F401  (registers the kernels' operators)

    extra = {_META: ""}
    with open(file, "rb") as f:
        program = torch.export.load(f, extra_files=extra)
    meta = json.loads(extra[_META]) if extra[_META] else {}
    if meta.get("format") != _FORMAT:
        raise ValueError(f"jit.load: {file!r} is a torch.export archive without "
                         f"the port's record ({_META}); jit.save writes one")
    return program, meta


class TranslatedLayer(torch.nn.Module):
    """A loaded ``.pdmodel`` program, callable like the layer it was saved
    from, on the device it was traced on.  Parameters are frozen inside the
    program; ``state_dict`` gives the sidecar parameters."""

    def __init__(self, exported, params: Optional[dict] = None,
                 meta: Optional[dict] = None):
        super().__init__()
        self._program = exported
        self._params_dict = params or {}
        self._meta = meta or {}
        self.device = torch.device(self._meta.get("device", "cpu"))
        self._run = exported.module()
        self.training = False

    def forward(self, *args):
        inputs = [(a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a)))
                  .to(self.device) for a in args]
        with torch.no_grad():
            outs = tuple(self._run(*inputs))
        return outs[0] if len(outs) == 1 else outs

    def state_dict(self, *a, **k):
        return dict(self._params_dict)


def load(path: str, **configs):
    """``jit.load``: a ``.pdmodel`` becomes a runnable
    :class:`TranslatedLayer`; with only ``.pdiparams`` present, the state
    dict (a parameters-only save)."""
    from ..framework.io import load as _load

    params = _load(path + ".pdiparams") if os.path.exists(path + ".pdiparams") else None
    if os.path.exists(path + ".pdmodel"):
        program, meta = _load_program(path + ".pdmodel")
        return TranslatedLayer(program, params, meta)
    if params is None:
        raise FileNotFoundError(
            f"jit.load: neither {path}.pdmodel nor {path}.pdiparams exists")
    return params
