"""Seeded, deterministic traffic generators (the workload library).

Every generator is a pure function of a ``numpy.random.Generator`` (or a
seed) — same seed, same trace, bit-for-bit — and produces either raw
arrival times in µs (``arrivals``) or full ``(t_us, payload)`` request
traces ready to drive a :class:`repro.scenario.Workload` of kind
``"trace"``:

* :mod:`repro.workloads.arrivals` — inhomogeneous-Poisson arrival
  processes: linear ramps (the sharded benchmark's "rush"), flash-crowd
  trapezoids, diurnal sinusoids, and a general Lewis-Shedler thinning
  driver for arbitrary rate curves;
* :mod:`repro.workloads.matching` — a matching-engine trading day for
  :class:`repro.apps.matching.MatchingEngineApp`: open/close auction
  spikes over a midday baseline, seeded order flow around a drifting
  mid price;
* :mod:`repro.workloads.llm` — session-based LLM serving traffic for
  :class:`repro.runtime.server.TokenServerApp`: a population of
  multi-turn conversations with seeded prompt/decode-length
  distributions and think-time gaps.
"""

from repro_torch.workloads.arrivals import (diurnal_times, flash_crowd_times,
                                      poisson_times, ramp_times,
                                      thinned_times)
from repro_torch.workloads.llm import llm_session_trace
from repro_torch.workloads.matching import auction_day_trace

__all__ = [
    "poisson_times",
    "ramp_times",
    "thinned_times",
    "flash_crowd_times",
    "diurnal_times",
    "auction_day_trace",
    "llm_session_trace",
]
