"""paddle_tpu_torch.distributed: the port of ``paddle_tpu.distributed``.

The process layer (ROADMAP A6a: the TCP store and rendezvous, the
communication watchdog, the collectives and P2P over a mesh driven from one
process or over ``torch.distributed``, ``init_parallel_env``,
``DataParallel``, the launch CLI), the model axis (A6b: ``meta_parallel``'s
tensor and sequence parallelism, context parallelism) and the schedules
(A6c: ``fleet``, ``DistributedTrainStep`` with ZeRO stages 1-3,
``ScannedLayers``, the GPipe and 1F1B engines, ``group_sharded_parallel``
and ``overlap``'s collective-matmul ring and gradient buckets) and their
remainder (A6c2: ZeRO offload, ``auto_parallel``'s placements,
``shard_layer`` and ``Engine``)."""

from . import auto_parallel  # noqa: F401
from . import communication  # noqa: F401
from . import fleet  # noqa: F401
from . import meta_parallel  # noqa: F401
from . import overlap  # noqa: F401
from .auto_parallel import (Partial, Placement, ProcessMesh, Replicate, Shard,  # noqa: F401
                            dtensor_from_fn, get_mesh, reshard, set_mesh, shard_layer,
                            shard_optimizer, shard_tensor)
from .communication import (P2POp, ReduceOp, all_gather, all_reduce, all_to_all,  # noqa: F401
                            barrier, batch_isend_irecv, broadcast, get_group, irecv,
                            isend, new_group, ppermute, recv, reduce, reduce_scatter,
                            scatter, scatter_stack, send, stream, wait)
from .engine import (DistributedTrainStep, GPipeLayers, ScannedLayers,  # noqa: F401
                     gpipe_spmd_step)
from .fleet import FaultDomain, HeartbeatLease, LeaseMonitor  # noqa: F401
from .parallel import (DataParallel, ParallelEnv, get_rank, get_world_size,  # noqa: F401
                       init_parallel_env, is_initialized)
from .pipeline_1f1b import (OneFOneBLayers, make_1f1b_schedule,  # noqa: F401
                            schedule_efficiency)
from .sharding import group_sharded_parallel, save_group_sharded_model  # noqa: F401
from .store import TCPKVStore, TCPStore, rendezvous  # noqa: F401
from .topology import (CommGroup, HybridCommunicateGroup, build_mesh,  # noqa: F401
                       get_hybrid_communicate_group, set_hybrid_communicate_group)
from .watchdog import CommWatchdog  # noqa: F401
