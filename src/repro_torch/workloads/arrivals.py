"""Inhomogeneous-Poisson arrival processes (seeded, deterministic).

All times are simulated µs from the start of the window; all rates are
requests per *second* (rps), matching :class:`repro.scenario.Workload`.
Every function takes an explicit ``numpy.random.Generator`` and draws
from it in a documented order, so callers can interleave further draws
(key choices, payload sizes) on the same stream reproducibly.
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np


def poisson_times(rng: np.random.Generator, rate_rps: float,
                  duration_us: float) -> np.ndarray:
    """Homogeneous Poisson arrivals: cumulative exponential gaps."""
    r = rate_rps / 1e6
    lam_total = r * duration_us
    gaps = rng.exponential(1.0 / r, size=int(lam_total * 1.1) + 100)
    times = np.cumsum(gaps)
    return times[times <= duration_us]


def ramp_times(rng: np.random.Generator, rate0_rps: float, rate1_rps: float,
               duration_us: float) -> np.ndarray:
    """Linearly ramping Poisson process rate0 → rate1 over the window,
    by inversion of the cumulative intensity Λ(t) = r0·t + slope·t²/2.

    Draw-for-draw identical to the hand-rolled "rush" this generalizes
    (``benchmarks/sharded.py``): exactly one ``rng.exponential`` call of
    size ``int(Λ_total·1.1)+100``, leaving the stream positioned for the
    caller's next draw — the sharded split gate asserts the resulting
    schedule byte-for-byte.
    """
    r0 = rate0_rps / 1e6          # ops per µs at t=0
    r1 = rate1_rps / 1e6
    slope = (r1 - r0) / duration_us
    lam_total = (r0 + r1) / 2.0 * duration_us
    lam = np.cumsum(rng.exponential(1.0, size=int(lam_total * 1.1) + 100))
    lam = lam[lam <= lam_total]
    if slope == 0.0:
        return lam / r0
    # invert Λ(t) = r0·t + slope·t²/2 for each arrival
    return (np.sqrt(r0 * r0 + 2.0 * slope * lam) - r0) / slope


def thinned_times(rng: np.random.Generator,
                  rate_fn: Callable[[float], float], peak_rps: float,
                  duration_us: float) -> np.ndarray:
    """General inhomogeneous Poisson via Lewis-Shedler thinning.

    ``rate_fn(t_us) -> rps`` must be bounded by ``peak_rps``.  Two draws
    per candidate arrival (gap, acceptance), in arrival order.
    """
    peak = peak_rps / 1e6
    out: List[float] = []
    t = 0.0
    while True:
        t += rng.exponential(1.0 / peak)
        if t >= duration_us:
            break
        if rng.random() * peak_rps <= rate_fn(t):
            out.append(t)
    return np.asarray(out, dtype=float)


def flash_crowd_rate(base_rps: float, peak_rps: float, t_start_us: float,
                     ramp_us: float, hold_us: float,
                     decay_us: float) -> Callable[[float], float]:
    """Trapezoid spike on a flat baseline: base → (ramp) → peak →
    (hold) → (decay) → base.  Returns the rate curve ``t_us -> rps``."""
    def rate(t: float) -> float:
        if t < t_start_us:
            return base_rps
        dt = t - t_start_us
        if dt < ramp_us:
            return base_rps + (peak_rps - base_rps) * (dt / ramp_us)
        dt -= ramp_us
        if dt < hold_us:
            return peak_rps
        dt -= hold_us
        if dt < decay_us:
            return peak_rps + (base_rps - peak_rps) * (dt / decay_us)
        return base_rps
    return rate


def flash_crowd_times(rng: np.random.Generator, base_rps: float,
                      peak_rps: float, t_start_us: float, ramp_us: float,
                      hold_us: float, decay_us: float,
                      duration_us: float) -> np.ndarray:
    """Flash-crowd arrivals: a trapezoid spike over a flat baseline."""
    rate = flash_crowd_rate(base_rps, peak_rps, t_start_us, ramp_us,
                            hold_us, decay_us)
    return thinned_times(rng, rate, max(base_rps, peak_rps), duration_us)


def diurnal_times(rng: np.random.Generator, mean_rps: float,
                  amplitude: float, period_us: float, duration_us: float,
                  phase: float = 0.0) -> np.ndarray:
    """Diurnal load curve: sinusoidal rate around ``mean_rps`` with
    relative ``amplitude`` in [0, 1) and the given period (a compressed
    "day").  Peak-to-trough ratio is (1+a)/(1-a)."""
    if not 0.0 <= amplitude < 1.0:
        raise ValueError(f"amplitude must be in [0, 1): {amplitude}")
    two_pi = 2.0 * np.pi

    def rate(t: float) -> float:
        return mean_rps * (1.0 + amplitude *
                           np.sin(two_pi * t / period_us + phase))

    return thinned_times(rng, rate, mean_rps * (1.0 + amplitude),
                         duration_us)
