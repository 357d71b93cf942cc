"""Matching-engine trading day: open/close auction spikes.

Produces a ``(t_us, payload)`` trace of :func:`repro.apps.matching
.order_req` orders shaped like an exchange session: an opening-auction
spike, a midday baseline, and a closing-auction spike — the classic
U-shaped intraday volume curve, compressed into a simulated window.
Order flow is seeded: sides alternate by Bernoulli draw, limit prices
random-walk around a drifting mid, quantities are geometric.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from repro_torch.apps.matching import order_req
from repro_torch.workloads.arrivals import thinned_times


def auction_day_rate(base_rps: float, open_peak_rps: float,
                     close_peak_rps: float, duration_us: float,
                     auction_frac: float = 0.12):
    """U-shaped intraday rate: exponential decay from the open spike,
    exponential climb into the close spike, flat baseline between."""
    span = auction_frac * duration_us

    def rate(t: float) -> float:
        r = base_rps
        if span > 0:
            r += (open_peak_rps - base_rps) * np.exp(-3.0 * t / span)
            r += (close_peak_rps - base_rps) * np.exp(
                -3.0 * (duration_us - t) / span)
        return r
    return rate


def auction_day_trace(seed: int, duration_us: float, base_rps: float,
                      open_peak_rps: float, close_peak_rps: float,
                      mid_price: int = 10_000, tick: int = 5,
                      auction_frac: float = 0.12,
                      ) -> List[Tuple[float, bytes]]:
    """Seeded order-flow trace for ``MatchingEngineApp``.

    Draw order: arrival times (thinning), then per-order (side, price
    offset, quantity) vectors.  The mid price random-walks one tick per
    order; buys quote below / sells above the mid by a geometric number
    of ticks, so the book stays crossed often enough to generate fills.
    """
    rng = np.random.default_rng(seed)
    rate = auction_day_rate(base_rps, open_peak_rps, close_peak_rps,
                            duration_us, auction_frac)
    peak = base_rps + max(open_peak_rps, close_peak_rps)
    times = thinned_times(rng, rate, peak, duration_us)
    n = len(times)
    buys = rng.random(n) < 0.5
    drift = np.cumsum(rng.integers(-1, 2, size=n)) * tick
    depth = rng.geometric(0.45, size=n) * tick       # ticks off the mid
    qty = rng.geometric(0.2, size=n)
    cross = rng.random(n) < 0.35                     # aggressive orders
    trace: List[Tuple[float, bytes]] = []
    for i, t in enumerate(times):
        mid = mid_price + int(drift[i])
        off = int(depth[i])
        if buys[i]:
            price = mid + off if cross[i] else mid - off
            side = "buy"
        else:
            price = mid - off if cross[i] else mid + off
            side = "sell"
        trace.append((float(t), order_req(side, i + 1, max(tick, price),
                                          int(qty[i]))))
    return trace
