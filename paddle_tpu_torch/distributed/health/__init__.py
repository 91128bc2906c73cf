"""The training health layer (port of the reference's
``distributed/health``): so far the host half of :mod:`.sdc`, the
checkpoint's value fingerprints.  The guard, the spike detector, the
rewind ledger, the SDC monitor and the straggler ladder wait for ROADMAP
A7b and raise.
"""

from .sdc import (SDC_POISON_REASON, SDCMonitor, SDCPolicy,  # noqa: F401
                  host_fingerprint, tree_fingerprints)

__all__ = ["SDCMonitor", "SDCPolicy", "SDC_POISON_REASON", "host_fingerprint",
           "tree_fingerprints"]

_WAITING = {"SpikeDetector": "the spike detector", "HealthGuard": "the health guard",
            "HealthPolicy": "the health guard", "REWIND_EXIT_CODE": "the health guard",
            "HealthError": "the rewind ledger", "RewindLedger": "the rewind ledger",
            "LEDGER_NAME": "the rewind ledger", "StragglerMonitor": "the straggler ladder",
            "StragglerPolicy": "the straggler ladder",
            "STRAGGLER_POISON_REASON": "the straggler ladder",
            "STRAGGLER_LINK_REASON": "the straggler ladder"}


def __getattr__(name):
    if name in _WAITING:
        raise NotImplementedError(
            f"distributed.health.{name} is not ported yet (ROADMAP A7b: {_WAITING[name]})")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
