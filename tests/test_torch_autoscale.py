"""The port's autoscaler (``serving/autoscaler.py``) and the fleet's
latency-outlier ejection against the JAX package's, on the CPU.

- The reference's ``tests/test_autoscale.py`` unit classes (the policy,
  the loop over fake clocks and leases, ``ReplicaPool.scale_to``, router
  churn, network faults, the warming retry hint, the meters and the
  report) and ``tests/test_straggler_serving.py``'s (degraded exclusion and
  detection, its meter, the autoscaler's and the report's view) run on the
  port through ``port_reference``.  Their SIGKILL chaos runs
  (``TestLoadRampChaosE2E``, ``TestDegradedServingChaosE2E``) are left
  out: the unit classes hold their verdicts, and ``test_torch_fleet.py``
  runs the one process-level fleet kill.
- The policy's decisions equal the reference's over a grid of signals.
"""

import itertools

import pytest
import torch

from paddle_tpu.serving.autoscaler import AutoscalePolicy as JaxPolicy
from paddle_tpu.serving.autoscaler import FleetSignals as JaxSignals

from paddle_tpu_torch.serving.autoscaler import AutoscalePolicy as TorchPolicy
from paddle_tpu_torch.serving.autoscaler import FleetSignals as TorchSignals

from test_torch_telemetry import _port_on_cpu, port_reference  # noqa: F401

torch.set_num_threads(1)

port_reference("test_autoscale", globals(), drop=("TestLoadRampChaosE2E",))
port_reference("test_straggler_serving", globals(), drop=("TestDegradedServingChaosE2E",),
               own_globals=True)


POLICIES = [dict(), dict(min_replicas=2, max_replicas=3), dict(up_thresh=0.6, down_thresh=0.4),
            dict(min_replicas=1, max_replicas=1)]


@pytest.mark.parametrize("policy", range(len(POLICIES)))
def test_policy_decisions_equal_the_reference(policy):
    mine, theirs = TorchPolicy(**POLICIES[policy]), JaxPolicy(**POLICIES[policy])
    n = 0
    for serving, warming, draining, degraded, qd, active, cap, pressure in itertools.product(
            (0, 1, 2, 3), (0, 1), (0, 1), (0, 1), (0, 2, 9), (0, 1, 4), (4, 8), (False, True)):
        kw = dict(serving=serving, warming=warming, draining=draining, degraded=degraded,
                  queue_depth=qd, active=active, capacity=cap)
        got = mine.decide(TorchSignals(**kw), pressure=pressure)
        want = theirs.decide(JaxSignals(**kw), pressure=pressure)
        assert got == want, kw
        n += got[0] is not None
    assert n > 0


def test_policy_from_env_equals_the_reference(monkeypatch):
    for k, v in (("PADDLE_TPU_AS_MIN", "2"), ("PADDLE_TPU_AS_MAX", "5"),
                 ("PADDLE_TPU_AS_UP_THRESH", "0.7"), ("PADDLE_TPU_AS_DOWN_THRESH", "0.2"),
                 ("PADDLE_TPU_AS_COOLDOWN_S", "3")):
        monkeypatch.setenv(k, v)
    assert vars(TorchPolicy.from_env()) == vars(JaxPolicy.from_env())
