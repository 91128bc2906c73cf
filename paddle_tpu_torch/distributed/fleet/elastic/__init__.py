"""Elastic training (port of the reference's ``distributed/fleet/elastic``):
so far the preemption guard (:mod:`.preemption`), which turns a SIGTERM
into an asynchronous sharded checkpoint and the restart exit code
:data:`ELASTIC_EXIT_CODE`.  The elastic manager, its file store, the
restart supervisors, the gang and the emergency handler wait for ROADMAP
A7b and raise.
"""

ELASTIC_EXIT_CODE = 101  # the restart code everywhere in the stack

from .preemption import PreemptionGuard  # noqa: E402

__all__ = ["ELASTIC_EXIT_CODE", "PreemptionGuard"]

_WAITING = frozenset({"ElasticManager", "ElasticStatus", "ElasticLevel", "FileStore",
                      "Supervisor", "RestartPolicy", "emergency_handler", "FleetSupervisor",
                      "GangPolicy", "HeartbeatLease"})


def __getattr__(name):
    if name == "HeartbeatLease":    # the fleet's lease, as the reference re-exports it
        from .. import HeartbeatLease

        return HeartbeatLease
    if name in _WAITING:
        raise NotImplementedError(
            f"fleet.elastic.{name} is not ported yet (ROADMAP A7b: the elastic "
            f"supervisor and gang)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
