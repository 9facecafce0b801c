"""Synthetic open-loop invocation traces (paper §5.3.2 workload shapes).

Every generator returns a sorted float array of arrival times in
microseconds on the simulated clock. All traces are deterministic in
``seed`` so benchmark JSON artifacts are reproducible run to run.

Three shapes cover the elastic-computing regimes the paper argues about:

* ``poisson_trace``  — steady-state open-loop arrivals (the Fig 12b
  serverless transfer measured at equilibrium),
* ``spike_trace``    — a Fig 14-style load spike: base rate with a burst
  window at ``spike_rate`` (this is where cold starts pile up and the
  control plane either is or is not on the critical path),
* ``diurnal_trace``  — a slow sinusoidal day/night swing, the classic
  FaaS fleet-utilization shape (thinned inhomogeneous Poisson).
"""

from __future__ import annotations

import numpy as np


def _homogeneous(rate_per_s: float, duration_us: float,
                 rng: np.random.RandomState) -> np.ndarray:
    """Poisson process arrivals in [0, duration_us)."""
    if rate_per_s <= 0 or duration_us <= 0:
        return np.zeros(0)
    rate_per_us = rate_per_s / 1e6
    # draw ~expected + 6 sigma gaps, then trim — avoids a python loop
    n_est = int(duration_us * rate_per_us)
    n_draw = max(16, n_est + int(6 * np.sqrt(max(n_est, 1))) + 4)
    gaps = rng.exponential(1.0 / rate_per_us, size=n_draw)
    t = np.cumsum(gaps)
    while t[-1] < duration_us:                       # rare: extend
        extra = rng.exponential(1.0 / rate_per_us, size=n_draw)
        t = np.concatenate([t, t[-1] + np.cumsum(extra)])
    return t[t < duration_us]


def poisson_trace(rate_per_s: float, duration_us: float,
                  seed: int = 0) -> np.ndarray:
    """Steady-state open-loop Poisson arrivals."""
    return _homogeneous(rate_per_s, duration_us,
                        np.random.RandomState(seed))


def spike_trace(base_rate_per_s: float, spike_rate_per_s: float,
                duration_us: float, spike_start_us: float,
                spike_len_us: float, seed: int = 0) -> np.ndarray:
    """Base-rate arrivals with a burst window at ``spike_rate_per_s``."""
    rng = np.random.RandomState(seed)
    peak = max(base_rate_per_s, spike_rate_per_s)
    t = _homogeneous(peak, duration_us, rng)
    in_spike = (t >= spike_start_us) & (t < spike_start_us + spike_len_us)
    rate = np.where(in_spike, spike_rate_per_s, base_rate_per_s)
    keep = rng.uniform(size=len(t)) < rate / peak    # thinning
    return t[keep]


def diurnal_trace(mean_rate_per_s: float, duration_us: float,
                  period_us: float, amplitude: float = 0.8,
                  seed: int = 0) -> np.ndarray:
    """Sinusoidal rate swing: rate(t) = mean * (1 + A sin(2 pi t/T))."""
    if not 0.0 <= amplitude <= 1.0:
        raise ValueError("amplitude must be in [0, 1]")
    rng = np.random.RandomState(seed)
    peak = mean_rate_per_s * (1.0 + amplitude)
    t = _homogeneous(peak, duration_us, rng)
    rate = mean_rate_per_s * (1.0 + amplitude
                              * np.sin(2.0 * np.pi * t / period_us))
    keep = rng.uniform(size=len(t)) < rate / peak    # thinning
    return t[keep]


TRACES = {
    "poisson": poisson_trace,
    "spike": spike_trace,
    "diurnal": diurnal_trace,
}
