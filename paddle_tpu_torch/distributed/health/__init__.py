"""The training health layer (port of the reference's
``distributed/health``): it defends against the failure mode that
dominates long pretraining runs, a process that stays alive while its
optimizer state is poisoned (NaN/Inf gradients, loss spikes, grad-norm
blowups, a chip that silently computes wrong numbers, a chip or link that
turns slow).

- :class:`SpikeDetector` — host-side statistical detector (rolling
  median/MAD or EMA z-score over loss and grad-norm).
- :class:`HealthPolicy` / :class:`HealthGuard` — the decide/recover state
  machine; plugs into ``jit.TrainStep(health_guard=...)`` (a probe on the
  device and a skip on the device), ``amp.GradScaler`` found-inf skips and
  ``StepMeter`` host feeds.
- :class:`RewindLedger` / :class:`HealthError` — persistent record of
  which data window triggered each rewind, so the supervisor-relaunched
  run skips past the poisoned batches; repeated rewinds at the same step
  fail loudly.
- :class:`SDCMonitor` / :class:`SDCPolicy` — silent-data-corruption
  fingerprints on the device, the cross-replica vote, confirmation and
  quarantine; :func:`host_fingerprint` / :func:`tree_fingerprints` pin
  checkpoint values.
- :class:`StragglerMonitor` / :class:`StragglerPolicy` — the straggler
  ladder: confirm a slow rank, tell chip from link, quarantine or remap.

Env: ``PADDLE_TPU_HEALTH=0`` disables the guard; ``PADDLE_TPU_SDC=0`` the
SDC monitor.
"""

from .detector import SpikeDetector  # noqa: F401
from .guard import REWIND_EXIT_CODE, HealthGuard, HealthPolicy  # noqa: F401
from .ledger import LEDGER_NAME, HealthError, RewindLedger  # noqa: F401
from .sdc import (SDC_POISON_REASON, SDCMonitor, SDCPolicy,  # noqa: F401
                  host_fingerprint, tree_fingerprints)
from .straggler import (STRAGGLER_LINK_REASON,  # noqa: F401
                        STRAGGLER_POISON_REASON, StragglerMonitor,
                        StragglerPolicy)

__all__ = ["SpikeDetector", "HealthGuard", "HealthPolicy", "HealthError",
           "RewindLedger", "LEDGER_NAME", "REWIND_EXIT_CODE",
           "SDCMonitor", "SDCPolicy", "SDC_POISON_REASON",
           "StragglerMonitor", "StragglerPolicy",
           "STRAGGLER_POISON_REASON", "STRAGGLER_LINK_REASON",
           "host_fingerprint", "tree_fingerprints"]
