"""Host-side statistical anomaly detection over loss / grad-norm series.

The device-side probe (``jit.TrainStep`` with a health guard) catches
NaN/Inf exactly; this detector catches the *finite* failure shapes that
precede or follow them in long pretraining runs — loss spikes and grad-norm
blowups (reference motivation: ``FLAGS_check_nan_inf`` only sees non-finite
values; PaLM-style run babysitting needs spike detection too).

Two estimators per series, both O(window):

- **robust z-score** (default): rolling median + MAD over the last
  ``window`` healthy samples. An observation is anomalous when
  ``(x - median) / (1.4826 * MAD + floor) > zmax``. Median/MAD shrug off
  the occasional outlier that a mean/std would chase.
- **EMA z-score** (``ema_alpha`` set): exponential mean/variance — O(1)
  memory, reacts faster to slow drift, less robust to bursts.

Anomalous samples are NOT folded into the statistics: a spike must not
teach the detector that spikes are normal (the escalation window in
``HealthPolicy`` bounds how long a persistent shift can keep flagging
before the guard rewinds). Detection is one-sided — a loss *drop* is
never an anomaly.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Optional

__all__ = ["SpikeDetector"]


class _Series:
    """One monitored scalar stream (loss or grad-norm)."""

    def __init__(self, name: str, window: int, min_history: int, zmax: float,
                 ema_alpha: Optional[float]):
        self.name = name
        self.window = window
        self.min_history = min_history
        self.zmax = zmax
        self.ema_alpha = ema_alpha
        self._hist: deque = deque(maxlen=window)
        self._ema_mean: Optional[float] = None
        self._ema_var = 0.0
        self._n = 0
        self.last_z: Optional[float] = None

    def _z_mad(self, x: float) -> float:
        hist = sorted(self._hist)
        n = len(hist)
        med = hist[n // 2] if n % 2 else 0.5 * (hist[n // 2 - 1] + hist[n // 2])
        dev = sorted(abs(h - med) for h in hist)
        mad = dev[n // 2] if n % 2 else 0.5 * (dev[n // 2 - 1] + dev[n // 2])
        # scale floor: a flat history (MAD 0 — tiny models converge to
        # machine-identical losses) must not turn float noise into z=inf
        scale = 1.4826 * mad + 1e-3 * abs(med) + 1e-12
        return (x - med) / scale

    def _z_ema(self, x: float) -> float:
        std = math.sqrt(max(self._ema_var, 0.0))
        scale = std + 1e-3 * abs(self._ema_mean) + 1e-12
        return (x - self._ema_mean) / scale

    def _absorb(self, x: float) -> None:
        self._n += 1
        self._hist.append(x)
        if self.ema_alpha is not None:
            if self._ema_mean is None:
                self._ema_mean = x
            else:
                a = self.ema_alpha
                d = x - self._ema_mean
                self._ema_mean += a * d
                self._ema_var = (1 - a) * (self._ema_var + a * d * d)

    def observe(self, x: Optional[float]) -> Optional[str]:
        """Feed one sample; returns an anomaly reason string or None.
        Non-finite samples return None — the device probe owns those."""
        if x is None:
            return None
        x = float(x)
        if not math.isfinite(x):
            return None
        if self._n >= self.min_history:
            z = self._z_ema(x) if self.ema_alpha is not None else self._z_mad(x)
            self.last_z = z
            if z > self.zmax:
                return f"{self.name}_spike z={z:.2f}"
        self._absorb(x)
        return None


class SpikeDetector:
    """Joint loss / grad-norm spike detector (see module docstring)."""

    def __init__(self, window: int = 128, min_history: int = 20,
                 loss_zmax: float = 6.0, grad_zmax: float = 6.0,
                 ema_alpha: Optional[float] = None):
        self.loss = _Series("loss", window, min_history, loss_zmax, ema_alpha)
        self.grad_norm = _Series("grad_norm", window, min_history, grad_zmax,
                                 ema_alpha)

    def observe(self, loss: Optional[float] = None,
                grad_norm: Optional[float] = None) -> Optional[str]:
        """Feed one step's values; returns the first anomaly reason (loss
        checked before grad-norm) or None when the step looks healthy."""
        r = self.loss.observe(loss)
        if r is not None:
            return r
        return self.grad_norm.observe(grad_norm)
