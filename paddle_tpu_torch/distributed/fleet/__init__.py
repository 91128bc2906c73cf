"""The fleet facade (port of the reference's ``distributed/fleet/``;
paddle's ``fleet/fleet.py:100``, ``base/distributed_strategy.py:175``,
``fleet/model.py:32``).

``fleet.init(is_collective=True, strategy=...)`` builds the hybrid group
from ``strategy.hybrid_configs`` and sets it:

- in a launched job (``PADDLE_TRAINERS_NUM`` above 1) or once a process
  group exists, it calls ``init_parallel_env`` and lays the degrees over the
  job's processes: a process mesh, one member a process (``Mesh.procs``);
- in a single process otherwise, a single-controller ``build_mesh`` over
  ``devices`` (keyword-only; default every visible card).  A mesh may repeat
  a device, so ``devices=["cuda:0"] * 8`` puts eight members on one card.

``distributed_model`` applies ``amp`` (O2 through ``amp.decorate``) and
``recompute`` (``config.recompute``) and turns a ``PipelineLayer`` into a
``PipelineParallel``; ``distributed_optimizer`` tags the optimizer with the
sharding stage (read by ``DistributedTrainStep``), master weights under
amp, and gradient merge's k and averaging (read by ``TrainStep``).  The
strategy's knob audit is the reference's: a reference knob the port does
not honor raises when set away from its default, an unknown knob or config
key raises.  ``strategy.asp`` (2:4 sparsity) wraps the optimizer in
``incubate.asp.decorate``; ``sharding_configs["offload"]`` tags
the optimizer, whose ``DistributedTrainStep`` then holds masters and
moments in pinned host memory.  ``elastic`` holds elastic training (the
manager, the supervisors, the gang and the preemption guard) and
``fault_domain`` the job's heartbeat leases, coordinated abort and gang
epoch (``FaultDomain``, ``HeartbeatLease``, ``LeaseMonitor``).
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch.distributed as dist
from torch import nn

from ..meta_parallel.pipeline_parallel import PipelineParallel
from ..meta_parallel.pp_layers import PipelineLayer
from ..topology import (HybridCommunicateGroup, Mesh, build_mesh,
                        get_hybrid_communicate_group, process_rank,
                        set_hybrid_communicate_group)

__all__ = ["DistributedStrategy", "init", "distributed_model", "distributed_optimizer",
           "get_hybrid_communicate_group", "worker_index", "worker_num", "Fleet", "fleet",
           "fault_domain", "FaultDomain", "HeartbeatLease", "LeaseMonitor"]


# reference ``distributed_strategy.proto:359`` fields the port does NOT
# honor, with their proto defaults; assigning a non-default value raises,
# so a config that expects an effect the port does not give fails loudly
_PROTO_UNHONORED: Dict[str, Any] = {
    "mode": 1, "localsgd": False, "dgc": False, "lars": False,
    "lamb": False, "elastic": False, "auto": False, "a_sync": True,
    "sync_nccl_allreduce": True, "nccl_comm_num": 1,
    "use_hierarchical_allreduce": False,
    "hierarchical_allreduce_inter_nranks": 1, "sync_batch_norm": False,
    "fuse_all_reduce_ops": True, "fuse_grad_size_in_MB": 32,
    "fuse_grad_size_in_TFLOPS": 50.0, "cudnn_exhaustive_search": False,
    "conv_workspace_size_limit": 512,
    "cudnn_batchnorm_spatial_persistent": False, "adaptive_localsgd": False,
    "fp16_allreduce": False, "last_comm_group_size_MB": 1.0,
    "tensor_parallel": False, "without_graph_optimization": True,
    "fuse_grad_size_in_num": 8, "calc_comm_same_stream": False,
    "fuse_grad_merge": False, "semi_auto": False, "adam_d2sum": False,
    "auto_search": False, "heter_ccl_mode": False, "is_fl_ps_mode": False,
    "with_coordinator": False, "qat": False, "split_data": True,
    "localsgd_configs": None, "dgc_configs": None, "a_sync_configs": None,
    "lars_configs": None, "lamb_configs": None,
    "adaptive_localsgd_configs": None, "tensor_parallel_configs": None,
    "trainer_desc_configs": None, "downpour_table_param": None,
    "fs_client_param": None, "qat_configs": None, "build_strategy": None,
    "execution_strategy": None, "gradient_scale_configs": None,
}

# honored keys per config dict (unknown keys raise at Fleet.init)
_CONFIG_KEYS: Dict[str, set] = {
    "hybrid_configs": {"dp_degree", "mp_degree", "pp_degree",
                       "sharding_degree", "sep_degree"},
    "amp_configs": {"level", "dtype"},
    # only keys with an actual consumer are allowed — an allowlisted-but-
    # ignored key would be the same silent rot the audit exists to stop
    "recompute_configs": set(),
    "sharding_configs": {"stage", "offload"},
    "pipeline_configs": {"accumulate_steps"},
    "gradient_merge_configs": {"k_steps", "avg"},
}


@dataclass
class DistributedStrategy:
    """The proto knobs the port honors (reference
    ``distributed_strategy.proto:359``).  Every other proto field is known by
    name and rejected when set to a non-default value; an unknown name
    raises at once: there is no silent catch-all."""

    hybrid_configs: Dict[str, Any] = field(default_factory=lambda: {
        "dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
        "sharding_degree": 1, "sep_degree": 1})
    amp: bool = False
    amp_configs: Dict[str, Any] = field(default_factory=dict)
    recompute: bool = False
    recompute_configs: Dict[str, Any] = field(default_factory=dict)
    sharding: bool = False
    sharding_configs: Dict[str, Any] = field(default_factory=dict)
    pipeline: bool = False
    pipeline_configs: Dict[str, Any] = field(default_factory=dict)
    gradient_merge: bool = False
    gradient_merge_configs: Dict[str, Any] = field(default_factory=dict)
    asp: bool = False  # 2:4 sparsity: distributed_optimizer applies incubate.asp.decorate
    find_unused_parameters: bool = False

    def __setattr__(self, name: str, value: Any) -> None:
        if name in self.__dataclass_fields__:
            object.__setattr__(self, name, value)
            return
        if name in _PROTO_UNHONORED:
            default = _PROTO_UNHONORED[name]
            if value != default:
                raise ValueError(
                    f"DistributedStrategy.{name} is a reference knob "
                    f"paddle_tpu_torch does not honor (the reference's compiler subsumes "
                    f"it or it is out of scope); setting it to {value!r} "
                    f"would have no effect — leave it at the default "
                    f"({default!r}) or remove it")
            object.__setattr__(self, name, value)
            return
        raise ValueError(
            f"unknown DistributedStrategy knob {name!r}; honored knobs: "
            f"{sorted(self.__dataclass_fields__)}")

    def _validate(self) -> None:
        """Reject unknown keys inside the honored config dicts (typos like
        'dp_degre' must not silently default)."""
        for cfg_name, allowed in _CONFIG_KEYS.items():
            cfg = getattr(self, cfg_name) or {}
            unknown = set(cfg) - allowed
            if unknown:
                raise ValueError(
                    f"DistributedStrategy.{cfg_name} has unknown key(s) "
                    f"{sorted(unknown)}; honored keys: {sorted(allowed)}")

    @property
    def sharding_stage(self) -> int:
        return int(self.sharding_configs.get("stage", 1)) if self.sharding else 0


class Fleet:
    def __init__(self):
        self._strategy: Optional[DistributedStrategy] = None
        self._hcg: Optional[HybridCommunicateGroup] = None

    def init(self, role_maker=None, is_collective: bool = True,
             strategy: Optional[DistributedStrategy] = None, log_level="INFO", *,
             devices=None) -> "Fleet":
        """Build and set the hybrid group (module docstring); unknown config
        keys raise here."""
        from ..parallel import init_parallel_env, is_initialized

        self._strategy = strategy or DistributedStrategy()
        self._strategy._validate()
        hc = self._strategy.hybrid_configs
        degrees = dict(dp=hc.get("dp_degree", 1), pp=hc.get("pp_degree", 1),
                       sharding=hc.get("sharding_degree", 1), sep=hc.get("sep_degree", 1),
                       mp=hc.get("mp_degree", 1))
        if int(os.environ.get("PADDLE_TRAINERS_NUM", "1")) > 1 and not is_initialized():
            init_parallel_env()
        if dist.is_available() and dist.is_initialized():
            if devices is not None:
                raise ValueError("fleet.init: devices= is for a single-controller mesh; "
                                 "a launched process drives its own device")
            world = dist.get_world_size()
            live = get_hybrid_communicate_group()
            own = live.mesh.devices.flat[0] if live is not None else None
            grid = build_mesh(**degrees, devices=[own or "cpu"] * world)
            mesh = Mesh(grid.devices, grid.axis_names,
                        np.arange(world).reshape(grid.devices.shape))
        else:
            mesh = build_mesh(**degrees, devices=devices)
        hcg = HybridCommunicateGroup(mesh=mesh)
        set_hybrid_communicate_group(hcg)
        self._hcg = hcg
        return self

    @property
    def strategy(self) -> Optional[DistributedStrategy]:
        return self._strategy

    def get_hybrid_communicate_group(self) -> Optional[HybridCommunicateGroup]:
        return self._hcg or get_hybrid_communicate_group()

    def distributed_model(self, model: nn.Module):
        """Wrap ``model`` by the strategy (reference ``model.py:141-160``):
        amp O2 casts it (``amp.decorate``), recompute sets
        ``config.recompute`` where the model has one (else a warning), a
        ``PipelineLayer`` becomes a ``PipelineParallel``; data parallelism
        and ZeRO are the ``DistributedTrainStep``'s."""
        st = self._strategy
        if st is not None and st.amp:
            from ...amp import decorate as _amp_decorate

            model = _amp_decorate(model, level=st.amp_configs.get("level", "O2"),
                                  dtype=st.amp_configs.get("dtype", "bfloat16"))
        if st is not None and st.recompute:
            cfg = getattr(model, "config", None)
            if cfg is not None and hasattr(cfg, "recompute"):
                cfg.recompute = True
            else:
                logging.getLogger("paddle_tpu_torch.distributed").warning(
                    "strategy.recompute=True but %s has no config.recompute switch; wrap "
                    "segments with fleet.utils.recompute", type(model).__name__)
        if isinstance(model, PipelineLayer):
            acc = st.pipeline_configs.get("accumulate_steps") if st else None
            return PipelineParallel(model, hcg=self._hcg, accumulate_steps=acc)
        return model

    def distributed_optimizer(self, optimizer, strategy=None):
        """Tag ``optimizer`` with the hybrid group, the sharding stage and
        offload (read by ``DistributedTrainStep``), f32 master weights under
        amp, gradient merge's k and averaging (read by ``TrainStep``; the
        reference's default k is 1), and with ``asp`` wraps it in
        ``incubate.asp.decorate``."""
        optimizer._hcg = self._hcg
        st = strategy or self._strategy
        optimizer._sharding_stage = st.sharding_stage if st else 0
        if st and st.amp:
            optimizer._multi_precision = True
        if st and st.sharding and st.sharding_configs.get("offload"):
            optimizer._sharding_offload = True
        if st and st.asp:
            from ...incubate.asp import decorate as _asp_decorate

            optimizer = _asp_decorate(optimizer)
        if st and st.gradient_merge:
            cfg = st.gradient_merge_configs or {}
            optimizer._gradient_merge_k = int(cfg.get("k_steps", 1))
            optimizer._gradient_merge_avg = bool(cfg.get("avg", True))
        return optimizer

    def worker_index(self) -> int:
        return process_rank()

    def worker_num(self) -> int:
        return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1

    def barrier_worker(self) -> None:
        from ..communication import barrier

        barrier()


fleet = Fleet()
init = fleet.init
distributed_model = fleet.distributed_model
distributed_optimizer = fleet.distributed_optimizer
worker_index = fleet.worker_index
worker_num = fleet.worker_num


from . import elastic  # noqa: E402,F401
from . import fault_domain  # noqa: E402,F401
from .fault_domain import FaultDomain, HeartbeatLease, LeaseMonitor  # noqa: E402,F401
