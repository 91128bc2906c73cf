"""The distributed training engine (port of the reference's
``distributed/engine.py``): :class:`DistributedTrainStep` over the hybrid
mesh, :class:`ScannedLayers` (a homogeneous stack held as ``[L, ...]``
parameters) and the GPipe engine (:class:`GPipeLayers`,
:func:`gpipe_spmd_step`).

The reference compiles one SPMD program and lets GSPMD partition it: the
batch over ``data`` x ``sharding``, the optimizer states (stage 1 and 2;
stage 2 also scatters the gradients) and at stage 3 the parameters over
``sharding``, the layer stack over ``pipe``.  The port runs eagerly, in the
two modes of ``distributed.topology``:

- **Single controller** (a mesh from ``build_mesh``): every tensor is
  global and every member's block is a view of it, so the result equals
  the reference's global arrays.  The step runs the port's ``TrainStep``
  (the kernels of the model's path through the mesh wrappers of
  ``ops/sharded.py``), then each member of the ``sharding`` axis updates
  its block of the f32 masters and moments: the states are held as the
  members' blocks stacked ``[n, *block]``, so a member's block is
  contiguous wherever the ``sharding`` axis lies, and B5 (``use_fused_adamw``)
  launches once a block.  A block's gradient is copied out when the
  ``sharding`` dim is not the leading one; its updated master is written
  back into the parameter's view (the all-gather).  Stage 2's bucketed
  reduction and stage 3's parameter blocks are value identities here: the
  gradients are global already and a parameter block is a view.
- **Multi-process** (``Mesh.procs``): each process takes its rows of the
  global batch (dim 0 over ``data`` x ``sharding``), the gradients are
  averaged over ``data`` and, at stages 1 and 2, reduce-scattered a bucket
  at a time over ``sharding`` (members' blocks packed member-major, so each
  process receives its own blocks), the global-norm clip sums the members'
  partial squares in f32, each process updates its block of the states,
  and the updated parameters are all-gathered.  Stage 0 all-reduces the
  gradients.  Stage 3, a ``pipe`` degree above 1 and a ``sep`` degree above
  1 across processes wait for ROADMAP A6d (the multi-card item) and raise.

ZeRO offload (``offload=True``, the reference's ``pinned_host`` memory
kind) holds every parameter's f32 master and moments, at any stage, in
pinned host memory (one ``device.HostArena`` a step, in the stacked layout
above): B5 reads the gradient on the card and updates the states across
the host link in place, writing the new bf16 value into the parameter's
view on the card; the gradients and parameters stay on the card.  It needs
the mesh's members on a card (``_offload_supported``); on the CPU the
request degrades with the reference's warning and the states stay where
they are.

The spec policy (:func:`param_storage_spec`, :func:`state_storage_spec`,
:func:`param_compute_spec`, :func:`grad_comm_axes`) is the reference's,
over the layer layouts the port records: ``model`` at a tensor-parallel
parameter's ``split_axis``, ``pipe`` on a stacked parameter's leading dim.
A spec is a tuple with one entry a dim: None, an axis, or a tuple of axes
(the reference's ``PartitionSpec``).  The step records them in
``_param_shardings``, ``_compute_shardings``, ``_grad_shardings`` and
``_state_shardings`` and on each parameter as ``_storage_spec``.
"""

from __future__ import annotations

import logging
import math
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from ..device import HostArena
from ..jit import TrainStep
from ..nn.clip import ClipGradByGlobalNorm
from ..nn.layer.layers import Layer
from .topology import CommGroup, process_mesh_coords

__all__ = ["DistributedTrainStep", "ScannedLayers", "GPipeLayers",
           "gpipe_spmd_step", "param_storage_spec", "state_storage_spec",
           "param_compute_spec", "grad_comm_axes"]


# -- the spec policy ---------------------------------------------------------

def _axes_of(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _current_spec(arr: torch.Tensor, mesh) -> List:
    """The layer layout of a parameter: what ScannedLayers recorded on a
    stacked one, an ``auto_parallel`` placement's spec when its mesh has
    ``mesh``'s axes and sizes (the reference reads the array's
    ``NamedSharding`` so), ``model`` at a tensor-parallel one's
    ``split_axis``, else replicated."""
    spec = getattr(arr, "_layer_spec", None)
    if spec is not None:
        return list(spec)
    placed = getattr(arr, "_dist_spec", None)
    if placed is not None and placed[0] == tuple(mesh.shape.items()):
        return list(placed[1])
    spec = [None] * arr.dim()
    if vars(arr).get("is_distributed") is True and hasattr(arr, "split_axis"):
        spec[arr.split_axis] = "model"
    return spec


def _add_axis(spec: List, axis: str, mesh, shape) -> List:
    """Shard the FIRST still-unsharded divisible dim over ``axis`` (the
    reference's rule: a dim naming only size-1 axes counts as unsharded and
    takes ``axis`` into a tuple)."""
    size = mesh.shape[axis]
    if size == 1:
        return spec
    if any(axis in _axes_of(s) for s in spec):
        return spec

    def tiling(entry):
        return math.prod(mesh.shape.get(a, 1) for a in _axes_of(entry))

    for d in range(len(shape)):
        if tiling(spec[d]) == 1 and shape[d] % size == 0 and shape[d] >= size:
            prior = _axes_of(spec[d])
            spec[d] = prior + (axis,) if prior else axis
            return spec
    return spec


def _strip_axis(spec: List, axis: str) -> List:
    """``spec`` without ``axis`` (the inverse of ``_add_axis``)."""
    out: List = []
    for s in spec:
        if s == axis:
            out.append(None)
        elif isinstance(s, tuple) and axis in s:
            rest = tuple(a for a in s if a != axis)
            out.append(rest if len(rest) > 1 else (rest[0] if rest else None))
        else:
            out.append(s)
    return out


def param_storage_spec(arr: torch.Tensor, mesh, stage: int) -> tuple:
    """Parameter STORAGE layout: the layer layout, plus ``sharding`` at
    stage 3."""
    spec = _current_spec(arr, mesh)
    if stage >= 3:
        spec = _add_axis(spec, "sharding", mesh, arr.shape)
    return tuple(spec)


def state_storage_spec(arr: torch.Tensor, mesh, stage: int) -> tuple:
    """Optimizer-state / master STORAGE layout: ``sharding`` from stage 1."""
    spec = _current_spec(arr, mesh)
    if stage >= 1:
        spec = _add_axis(spec, "sharding", mesh, arr.shape)
    return tuple(spec)


def param_compute_spec(storage) -> tuple:
    """COMPUTE layout: the storage layout without the ``sharding`` axis."""
    return tuple(_strip_axis(list(storage), "sharding"))


def grad_comm_axes(mesh) -> tuple:
    """The sized gradient-reduction axes, ``sharding`` first."""
    return tuple(a for a in ("sharding", "data") if mesh.shape.get(a, 1) > 1)


def _sharding_dim(spec) -> Optional[int]:
    for d, entry in enumerate(spec):
        if "sharding" in _axes_of(entry):
            return d
    return None


def _blocks(t: torch.Tensor, dim: int, n: int) -> List[torch.Tensor]:
    w = t.shape[dim] // n
    return [t.narrow(dim, j * w, w) for j in range(n)]


def _a6d(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"DistributedTrainStep: {what} across processes is not ported yet (ROADMAP "
        "A6d, the multi-card item); run it on a single-controller mesh (build_mesh)")


class DistributedTrainStep(TrainStep):
    """``TrainStep`` over the hybrid mesh (module docstring).

    ``sharding_stage``: 0 (data parallelism) | 1 | 2 | 3 (ZeRO; default
    from ``group_sharded_parallel``'s or ``fleet.distributed_optimizer``'s
    tag).  ``hcg``: a ``HybridCommunicateGroup`` or a ``Mesh``.
    ``batch_specs``: a spec for each batch argument (default: dim 0 over
    ``data`` x ``sharding``, dim 1 over ``sep``).  ``offload`` (default
    from the optimizer's ``_sharding_offload`` tag): masters and moments in
    pinned host memory where the members are cards, else a warning and
    resident states (``self.offload`` says which).  ``health_guard`` and
    ``snapshotter`` work as in ``TrainStep`` (the guarded update selects
    each member's block); an SDC monitor's rank-local pre-reduce lanes tap
    the gradient buckets (``_sdc_pre_reduce_groups``).  ``persistent_cache``
    raises as ``TrainStep``'s does."""

    def __init__(self, model: nn.Module, loss_fn: Callable, optimizer, hcg,
                 sharding_stage: Optional[int] = None,
                 batch_specs: Optional[Sequence] = None, donate: bool = True,
                 offload: Optional[bool] = None, gradient_merge: Optional[int] = None,
                 health_guard=None, persistent_cache=None, snapshotter=None):
        self.hcg = hcg
        self.mesh = getattr(hcg, "mesh", hcg)
        if sharding_stage is None:
            sharding_stage = getattr(optimizer, "_sharding_stage", None) or \
                getattr(model, "_sharding_stage", None) or 0
        if sharding_stage not in (0, 1, 2, 3):
            raise ValueError(f"sharding_stage must be 0, 1, 2 or 3, got {sharding_stage}")
        self.sharding_stage = int(sharding_stage)
        if offload is None:
            offload = bool(getattr(optimizer, "_sharding_offload", False))
        self.offload = bool(offload) and self._offload_supported()
        if offload and not self.offload:
            logging.getLogger("paddle_tpu.distributed").warning(
                "offload=True requested but this backend (%s) cannot place optimizer "
                "states in pinned host memory; optimizer states stay in device memory",
                self.mesh.devices.flat[0].type)
        self._batch_specs = batch_specs
        super().__init__(model, loss_fn, optimizer, donate=donate,
                         gradient_merge=gradient_merge, health_guard=health_guard,
                         persistent_cache=persistent_cache, snapshotter=snapshotter)
        self._multi = self.mesh.procs is not None
        if self._multi:
            shape = self.mesh.shape
            if self.sharding_stage >= 3:
                raise _a6d("sharding stage 3")
            for axis in ("pipe", "sep"):
                if shape.get(axis, 1) > 1:
                    raise _a6d(f"a {axis} degree of {shape[axis]}")
            clip = optimizer._grad_clip
            if clip is not None and not isinstance(clip, ClipGradByGlobalNorm):
                raise NotImplementedError(
                    f"DistributedTrainStep across processes clips by the global norm "
                    f"only, got {type(clip).__name__}")
        self._place_state()
        self._grad_bucketer = self._build_bucketer()
        self._telemetry_program = self._register_telemetry()

    def _register_telemetry(self):
        """The step's analytic collective profile, registered once: the
        gradient reduction over ``data`` x ``sharding`` (a reduce-scatter
        when optimizer states are sharded, one a bucket when bucketed),
        whose execution counter each call bumps."""
        try:
            from .. import telemetry

            n_red = self.mesh.shape.get("data", 1) * self.mesh.shape.get("sharding", 1)
            if n_red <= 1:
                return None
            grad_bytes = sum(p.numel() * p.element_size() for p in self._params
                             if p.requires_grad)
            kind = "reduce_scatter" if (self.sharding_stage >= 1
                                        and self.mesh.shape.get("sharding", 1) > 1) \
                else "all_reduce"
            axes = list(grad_comm_axes(self.mesh))
            if self._grad_bucketer is not None:
                collectives = [{"kind": kind, "nbytes": int(nb), "group_size": n_red,
                                "count": 1, "axes": axes}
                               for nb in self._grad_bucketer.bucket_nbytes()]
            else:
                collectives = [{"kind": kind, "nbytes": int(grad_bytes), "group_size": n_red,
                                "count": 1, "axes": axes}]
            return telemetry.register_traced_program(
                f"DistributedTrainStep_stage{self.sharding_stage}", collectives)
        except Exception:
            return None

    def __call__(self, *batch) -> torch.Tensor:
        loss = super().__call__(*batch)
        if self._telemetry_program is not None:
            self._telemetry_program.record_execution()
        return loss

    def _sdc_pre_reduce_groups(self, grads):
        """Per-bucket pre-reduce fingerprint taps (``grads`` aligned with
        the parameters, None where a parameter has no gradient): one
        rank-local lane pair per comm bucket, plus one per unbucketed
        gradient, so a confirmed suspect's post-mortem names WHICH
        reduction diverged.  Diagnostic only — pre-reduce gradients come
        from different data shards, so the vote never compares them."""
        b = self._grad_bucketer
        if b is None:
            return [], []
        return b.fingerprint_groups(grads)

    def _offload_supported(self) -> bool:
        """Pinned host memory needs the members on a card (the reference's
        probe: its backend must compile host-memory placements)."""
        return self.mesh.devices.flat[0].type == "cuda"

    # -- placement ----------------------------------------------------------
    def _place_state(self) -> None:
        """Record the specs, and hold each parameter's optimizer states (and
        f32 master) as its ``sharding`` members' blocks: on the parameter's
        device, or with offload in one pinned ``HostArena``, filled a
        parameter at a time (no parameter's states are ever all on the card)."""
        mesh, opt, stage = self.mesh, self.optimizer, self.sharding_stage
        n = mesh.shape.get("sharding", 1)
        me = process_mesh_coords(mesh)["sharding"] if self._multi else None
        self.state_memory_kind = "pinned_host" if self.offload else "device"
        self._param_shardings, self._compute_shardings = [], []
        self._grad_shardings, self._state_shardings = [], []
        plan = []       # (p, has_master, dim, the held shape)
        for p in self._params:
            ps = param_storage_spec(p, mesh, stage)
            ss = state_storage_spec(p, mesh, stage)
            p._storage_spec = ps
            self._param_shardings.append(ps)
            self._compute_shardings.append(param_compute_spec(ps))
            self._grad_shardings.append(ss)
            has_master = opt._has_master(p)
            self._state_shardings.append(
                {**{s: ss for s in opt._slot_names}, **({"@master": ss} if has_master else {})})
            dim = _sharding_dim(ss)
            shape = list(p.shape)
            if dim is not None:     # the members' blocks, stacked [n, *block]
                shape[dim] //= n    # (across processes only this one's: [1, *block])
                shape = [n if me is None else 1] + shape
            plan.append((p, has_master, dim, tuple(shape)))
        arena = None
        if self.offload:
            if opt._host_arena is not None:
                opt._host_arena.release()
            arena = opt._host_arena = HostArena(sum(
                HostArena.span([shape] * (len(opt._slot_names) + has_master),
                               opt._update_dtype(p)) for p, has_master, _, shape in plan),
                pin=self.mesh.devices.flat[0].type == "cuda")
        for p, has_master, dim, shape in plan:
            dtype = opt._update_dtype(p)
            if dim is None:
                held = lambda t: t      # noqa: E731
            elif me is None:
                held = lambda t: torch.stack(_blocks(t, dim, n)).contiguous()  # noqa: E731
            else:
                held = lambda t: _blocks(t, dim, n)[me].contiguous()[None]    # noqa: E731

            def put(t):
                return held(t) if arena is None else arena.take(shape, dtype).copy_(held(t))

            st = opt._accumulators.get(id(p))
            if st is None:
                st = {s: torch.full(shape, opt._slot_init(s), dtype=dtype, device=p.device)
                      if arena is None else arena.take(shape, dtype).fill_(opt._slot_init(s))
                      for s in opt._slot_names}
                st["@t"] = 0
            else:
                st = {k: v if isinstance(v, int) else put(v) for k, v in st.items()}
            opt._accumulators[id(p)] = st
            if has_master:
                mw = opt._master_weights.get(id(p))
                opt._master_weights[id(p)] = put(mw if mw is not None else p.detach().float())
            if dim is not None:
                opt._layouts[id(p)] = (dim, n)

    def _build_bucketer(self):
        """Size-targeted gradient buckets for the sharded-optimizer stages
        (``PADDLE_TPU_BUCKET_MB``, or ``group_sharded_parallel``'s
        ``buffer_max_size``; 0 disables); a gradient tiled on an axis
        outside the reduction axes (``model``, ``pipe``) is reduced on its
        own, as the reference's."""
        from .overlap import GradientBucketer, grad_bucket_bytes

        n_red = self.mesh.shape.get("data", 1) * self.mesh.shape.get("sharding", 1)
        if self.sharding_stage < 1 or n_red <= 1:
            return None
        bb = grad_bucket_bytes(getattr(self.optimizer, "_grad_bucket_bytes", None))
        if bb <= 0:
            return None
        red = set(grad_comm_axes(self.mesh))

        def keeps_other_tiling(spec) -> bool:
            return any(a not in red and self.mesh.shape.get(a, 1) > 1
                       for entry in spec for a in _axes_of(entry))

        sizes = [p.numel() * p.element_size() for p in self._params]
        keys = [str(p.dtype) for p in self._params]
        skip = [keeps_other_tiling(cs) for cs in self._compute_shardings]
        if self._multi:   # a replicated state reduces whole, outside the buckets
            skip = [s or id(p) not in self.optimizer._layouts
                    for s, p in zip(skip, self._params)]
        return GradientBucketer(sizes, bucket_bytes=bb, keys=keys, reverse=True, skip=skip)

    # -- the batch ----------------------------------------------------------
    def _default_batch_spec(self, batch_ndim: int) -> List:
        """Dim 0 over data (x sharding), dim 1 over sep."""
        spec: List = [None] * batch_ndim
        spec[0] = ("data", "sharding") if self.mesh.shape["sharding"] > 1 else "data"
        if batch_ndim >= 2 and self.mesh.shape["sep"] > 1:
            spec[1] = "sep"
        return spec

    def _batch(self, batch) -> List[torch.Tensor]:
        arrays = super()._batch(batch)
        if not self._multi:
            return arrays
        coords = process_mesh_coords(self.mesh)
        out = []
        for i, a in enumerate(arrays):
            spec = list(self._batch_specs[i]) if self._batch_specs is not None \
                else self._default_batch_spec(a.dim())
            for d, entry in enumerate(spec):
                axes = _axes_of(entry)
                n = math.prod(self.mesh.shape[x] for x in axes)
                if n > 1:
                    at = 0
                    for x in axes:
                        at = at * self.mesh.shape[x] + coords[x]
                    a = _blocks(a, d, n)[at]
            out.append(a)
        return out

    # -- the update ---------------------------------------------------------
    def _loss_and_grads(self, arrays):
        loss, grads = super()._loss_and_grads(arrays)
        if self._multi:
            red = CommGroup(self.mesh, ("data", "sharding"))
            loss = loss.clone()
            if red.nranks > 1:
                from .communication import _mp_all_reduce

                _mp_all_reduce(loss, "avg", red)
        return loss, grads

    def _update(self, grads) -> None:
        if self._multi:
            return self._update_processes(grads)
        by_id = {id(p): g for p, g in grads}
        if self._grad_bucketer is not None:
            self._grad_bucketer.constrain([by_id.get(id(p)) for p in self._params], self.mesh,
                                          grad_comm_axes(self.mesh))
        self._apply_blocks(self.optimizer._clipped(grads),
                           lambda p, g, dim, n: _blocks(g, dim, n), None)

    @torch.no_grad()
    def _apply_blocks(self, grads, grad_blocks, member: Optional[int]) -> None:
        """The update of every parameter, a ``sharding`` member's block at a
        time: ``grad_blocks(p, g, dim, n)`` gives the gradient's blocks
        (all members', or only ``member``'s across processes)."""
        opt = self.optimizer
        base_lr = opt.get_lr()
        for p, g in grads:
            lr = base_lr * getattr(p, "optimize_attr", {}).get("learning_rate", 1.0)
            layout = opt._layouts.get(id(p))
            if layout is None:
                opt._update_param(p, g, lr)
                continue
            st = opt._state_for(p)
            dim, n = layout
            master = opt._master_weights.get(id(p))
            views = _blocks(p, dim, n)
            if opt._whole_tensor and member is None:
                self._apply_whole(p, grad_blocks(p, g, dim, n), st, master, views, lr)
                continue
            members = range(n) if member is None else [member]
            for k, (j, gb) in enumerate(zip(members, grad_blocks(p, g, dim, n))):
                slots = {s: st[s][k] for s in opt._slot_names}
                view = views[j]
                work = master[k] if master is not None else \
                    (view if view.is_contiguous() else view.contiguous())
                out = None      # an offloaded master: B5 writes the card's view
                if work.device != view.device:
                    out = view if view.is_contiguous() else \
                        torch.empty_like(view, memory_format=torch.contiguous_format)
                new_w, new_st = opt._update_rule(work, gb.contiguous(), {**slots, "@t": st["@t"]},
                                                 lr, p, out=out)
                new_w, new_st = opt._kept(new_w, work), opt._kept_state(new_st, slots)
                for s, v in slots.items():
                    if new_st[s] is not v:
                        v.copy_(new_st[s])
                if new_w is not work:
                    work.copy_(new_w)
                if out is not None:
                    if out is not view:
                        view.copy_(out)
                elif work is not view:
                    view.copy_(work)
            st["@t"] = new_st.get("@t", st["@t"])
        opt._step_count += 1

    def _apply_whole(self, p, grad_blocks, st, master, views, lr) -> None:
        """A rule that reads the whole parameter (Lamb's trust ratio) on one
        controller: one update of the members' blocks stacked [n, *block]."""
        opt = self.optimizer
        work = master if master is not None else torch.stack(views)
        slots = {s: st[s] for s in opt._slot_names}
        new_w, new_st = opt._update_rule(work, torch.stack(grad_blocks), {**slots, "@t": st["@t"]},
                                         lr, p)
        new_w, new_st = opt._kept(new_w, work), opt._kept_state(new_st, slots)
        for s, v in slots.items():
            v.copy_(new_st[s])
        if master is not None:
            master.copy_(new_w)
        for j, view in enumerate(views):
            view.copy_(new_w[j])
        st["@t"] = new_st.get("@t", st["@t"])

    def _update_processes(self, grads) -> None:
        """Across processes: average over ``data``, reduce-scatter the
        buckets over ``sharding`` (stage 0: all-reduce), clip by the global
        norm, update this process's blocks, all-gather the parameters."""
        from .communication import _mp_all_reduce, _mp_reduce_scatter, _process_group

        mesh, opt = self.mesh, self.optimizer
        data, shard = CommGroup(mesh, ("data",)), CommGroup(mesh, ("sharding",))
        both = CommGroup(mesh, ("data", "sharding"))
        me = process_mesh_coords(mesh)["sharding"]
        if opt._whole_tensor and shard.nranks > 1:
            raise NotImplementedError(
                f"{type(opt).__name__} reads each whole parameter (Lamb's trust ratio), which "
                "ZeRO splits across processes here: run it on one controller "
                "(devices=[...]) or without a sharding degree")
        grads = [(p, g.to(torch.float32 if opt._has_master(p) else p.dtype).contiguous())
                 for p, g in grads]
        by_id = {id(p): g for p, g in grads}
        mine = {}       # id(p) -> this process's gradient block, reduced
        b = self._grad_bucketer
        buckets = b.buckets if b is not None else \
            [[i] for i, p in enumerate(self._params) if id(p) in opt._layouts]
        in_bucket = {i for bk in buckets for i in bk}
        for bk in buckets:
            members = [i for i in bk if id(self._params[i]) in by_id]
            if not members:
                continue
            layouts = {i: opt._layouts[id(self._params[i])] for i in members}
            flat = torch.cat([blk.reshape(-1) for j in range(shard.nranks) for i in members
                              for blk in [_blocks(by_id[id(self._params[i])],
                                                  *layouts[i])[j]]])
            if data.nranks > 1:
                _mp_all_reduce(flat, "avg", data)
            if shard.nranks > 1:
                flat = _mp_reduce_scatter(flat, "avg", shard)
            off = 0
            for i in members:
                p = self._params[i]
                dim, n = layouts[i]
                shape = list(p.shape)
                shape[dim] //= n
                size = math.prod(shape)
                mine[id(p)] = flat[off:off + size].reshape(shape)
                off += size
        for i, p in enumerate(self._params):
            if id(p) in by_id and i not in in_bucket:
                g = by_id[id(p)]
                if both.nranks > 1:
                    _mp_all_reduce(g, "avg", both)
                if id(p) in opt._layouts:
                    mine[id(p)] = _blocks(g, *opt._layouts[id(p)])[me]
        grads = [(p, mine.get(id(p), g)) for p, g in grads]
        if opt._grad_clip is not None:
            grads = self._clip_processes(grads, shard)
        self._apply_blocks(grads, lambda p, g, dim, n: [g], me)
        pg, _ = _process_group(shard)
        for p, _ in grads:
            layout = opt._layouts.get(id(p))
            if layout is None or shard.nranks == 1:
                continue
            dim, n = layout
            views = _blocks(p.data, dim, n)
            parts = [torch.empty_like(views[me], memory_format=torch.contiguous_format)
                     for _ in range(n)]
            dist.all_gather(parts, views[me].contiguous(), group=pg)
            for v, part in zip(views, parts):
                v.copy_(part)

    def _clip_processes(self, grads, shard: CommGroup):
        """The global-norm clip over blocks: each parameter's sum of squares
        in f32, a ZeRO block's summed over ``sharding`` and a
        tensor-parallel shard's over ``model`` (one all-reduce of the
        partial sums each), then summed in parameter order."""
        from .communication import _mp_all_reduce

        clip, opt = self.optimizer._grad_clip, self.optimizer
        clipped = [(p, g) for p, g in grads if g is not None and getattr(p, "need_clip", True)]
        if not clipped:
            return grads
        parts = torch.stack([g.float().square().sum() for _, g in clipped])
        for group, split in ((shard, lambda p: id(p) in opt._layouts),
                             (CommGroup(self.mesh, ("model",)),
                              lambda p: vars(p).get("is_distributed") is True)):
            if group.nranks == 1:
                continue
            mask = torch.tensor([split(p) for p, _ in clipped], device=parts.device)
            partial = torch.where(mask, parts, torch.zeros_like(parts))
            _mp_all_reduce(partial, "sum", group)
            parts = torch.where(mask, partial, parts)
        norm = torch.sqrt(parts.sum())
        scale = clip.clip_norm / torch.clamp(norm, min=clip.clip_norm)
        return [(p, g if g is None or not getattr(p, "need_clip", True)
                 else (g.float() * scale).to(g.dtype)) for p, g in grads]


# -- the layer stack ---------------------------------------------------------

class ScannedLayers(Layer):
    """N homogeneous layers held as stacked ``[L, ...]`` parameters (named
    as the template's with ``.`` as ``__``: ``self_attn__q_proj__weight``),
    the leading dim over ``pipe`` when its degree is above 1.  The first
    layer stays as the frozen ``template`` (registered as ``_template`` and
    ``template``, the reference's state-dict keys); the forward runs it L
    times, each with one layer's slices (``torch.func.functional_call``).

    ``layers`` may be any sequence; the stacks are filled one layer at a
    time, so a sequence that builds its layers on access keeps one
    unstacked layer alive at a time (the template aside)."""

    def __init__(self, layers: Sequence[nn.Module], mesh=None, pipe_axis: str = "pipe"):
        super().__init__()
        n = len(layers)
        if n == 0:
            raise ValueError("ScannedLayers needs at least one layer")
        it = iter(layers)
        first = next(it)
        self._template = first
        self.add_module("template", first)
        self._n = n
        shapes = {name: (p.shape, p.dtype) for name, p in first.named_parameters()}
        self._stack_names = list(shapes)
        stacks = {name: torch.empty((n, *p.shape), dtype=p.dtype, device=p.device)
                  for name, p in first.named_parameters()}
        self._fill(stacks, shapes, 0, first)
        for i, layer in enumerate(it, 1):
            self._fill(stacks, shapes, i, layer)
            del layer
        for p in first.parameters():
            p.requires_grad_(False)
        lead = pipe_axis if mesh is not None and mesh.shape.get(pipe_axis, 1) > 1 else None
        for name, p in first.named_parameters():
            t = nn.Parameter(stacks.pop(name))
            t._layer_spec = (lead, *_current_spec(p, mesh))
            t.is_distributed = vars(p).get("is_distributed", False)
            if hasattr(p, "split_axis"):
                t.split_axis = p.split_axis + 1
            self.register_parameter(name.replace(".", "__"), t)

    @staticmethod
    def _fill(stacks, shapes, i: int, layer: nn.Module) -> None:
        got = {name: p for name, p in layer.named_parameters()}
        if list(got) != list(shapes) or any((p.shape, p.dtype) != shapes[name]
                                            for name, p in got.items()):
            raise ValueError("ScannedLayers requires homogeneous layers")
        with torch.no_grad():
            for name, p in got.items():
                stacks[name][i].copy_(p)

    def _stacked(self) -> List[torch.Tensor]:
        return [self._parameters[n.replace(".", "__")] for n in self._stack_names]

    def _layer_params(self, stacks: Sequence[torch.Tensor]):
        """One dict a layer of ``stacks`` (each [k, ...]) into its slices."""
        slices = [s.unbind(0) for s in stacks]
        return [dict(zip(self._stack_names, parts)) for parts in zip(*slices)]

    def _run(self, params, x, *extra):
        return torch.func.functional_call(self._template, params, (x, *extra))

    def forward(self, x, *extra):
        for params in self._layer_params(self._stacked()):
            x = self._run(params, x, *extra)
        return x

    def __len__(self) -> int:
        return self._n


class GPipeLayers(ScannedLayers):
    """GPipe over the ``pipe`` members (the reference's compiled schedule,
    run eagerly): the batch is cut into ``num_microbatches``; micro-batch i
    is at stage s on tick i + s; each tick every stage runs its L/P layers
    on what it holds (the bubble's ticks on zeros, as the reference's scan
    does), on its member's device; M + P - 1 ticks.  Autograd over the
    whole schedule gives the backward.  ``segments_run`` counts the stage
    segments executed."""

    def __init__(self, layers: Sequence[nn.Module], mesh, num_microbatches: int,
                 pipe_axis: str = "pipe"):
        p = max(1, mesh.shape[pipe_axis])
        if len(layers) % p != 0:
            raise ValueError(f"{len(layers)} layers not divisible by pipe degree {p}")
        if mesh.procs is not None and p > 1:
            raise NotImplementedError(
                "pipeline stages across processes are not ported yet (ROADMAP A6d); "
                "run the pipeline on a single-controller mesh (build_mesh)")
        super().__init__(layers, mesh, pipe_axis)
        self._mesh = mesh
        self._pipe_axis = pipe_axis
        self.num_microbatches = int(num_microbatches)
        self.segments_run = 0

    def _segment(self, params, h, dev):
        h = h.to(dev)
        for lp in params:
            h = self._run({k: v.to(dev) for k, v in lp.items()}, h)
        self.segments_run += 1
        return h

    def forward(self, x):
        P = self._mesh.shape[self._pipe_axis]
        m = self.num_microbatches
        if P == 1:
            return super().forward(x)
        if x.shape[0] % m != 0:
            raise ValueError(f"batch {x.shape[0]} not divisible by num_microbatches {m}")
        xs = x.chunk(m)
        layers = self._layer_params(self._stacked())
        ell = len(layers) // P
        devs = self._mesh.axis_devices(self._pipe_axis)
        state = [torch.zeros_like(xs[0])] * P
        ys: List[Optional[torch.Tensor]] = [None] * m
        for t in range(m + P - 1):
            outs = [self._segment(layers[s * ell:(s + 1) * ell],
                                  xs[min(t, m - 1)] if s == 0 else state[s], devs[s])
                    for s in range(P)]
            if t >= P - 1:
                ys[t - (P - 1)] = outs[-1].to(x.device)
            state = [outs[-1]] + outs[:-1]      # the ring hop to stage s + 1
        return torch.cat(ys)


def gpipe_spmd_step(layers: Sequence[nn.Module], mesh, num_microbatches: int,
                    pipe_axis: str = "pipe") -> GPipeLayers:
    """The GPipe module (:class:`GPipeLayers`) over ``layers``."""
    return GPipeLayers(layers, mesh, num_microbatches, pipe_axis)
