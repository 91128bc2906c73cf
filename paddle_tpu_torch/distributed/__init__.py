"""paddle_tpu_torch.distributed: the port of ``paddle_tpu.distributed``.

So far its process layer (ROADMAP A6a): the TCP store and rendezvous, the
communication watchdog, the collectives and P2P over a mesh driven from one
process or over ``torch.distributed`` (NCCL on the card, gloo on the CPU),
``init_parallel_env``, ``DataParallel`` and the launch CLI
(``python -m paddle_tpu_torch.distributed.launch``); ``topology`` with its
``data`` and ``sep`` axes, ``meta_parallel.context_parallel`` and
``fleet_utils``' activation recompute."""

from . import communication  # noqa: F401
from .communication import (P2POp, ReduceOp, all_gather, all_reduce, all_to_all,  # noqa: F401
                            barrier, batch_isend_irecv, broadcast, get_group, irecv,
                            isend, new_group, ppermute, recv, reduce, reduce_scatter,
                            scatter, scatter_stack, send, stream, wait)
from .parallel import (DataParallel, ParallelEnv, get_rank, get_world_size,  # noqa: F401
                       init_parallel_env, is_initialized)
from .store import TCPKVStore, TCPStore, rendezvous  # noqa: F401
from .topology import (CommGroup, HybridCommunicateGroup, build_mesh,  # noqa: F401
                       get_hybrid_communicate_group, set_hybrid_communicate_group)
from .watchdog import CommWatchdog  # noqa: F401
