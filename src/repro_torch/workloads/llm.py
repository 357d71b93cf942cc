"""Session-based LLM serving traffic (multi-turn conversations).

Models a population of users holding multi-turn conversations with a
replicated token server (:class:`repro.runtime.server.TokenServerApp`):
sessions arrive by a (possibly inhomogeneous) Poisson process, each
session runs a geometric number of turns, and every turn submits a
``{"session", "prompt", "n"}`` request — first-turn prompts are long
(the user pastes context), follow-ups short, decode lengths lognormal.
Turn gaps are think times, so a flash crowd of *arrivals* compounds
into sustained request pressure as the sessions it admitted keep
talking.

Everything is drawn from one seeded generator in a documented order —
the same seed reproduces the same trace bit-for-bit.
"""

from __future__ import annotations

import json
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.workloads.arrivals import poisson_times


def llm_session_trace(
    seed: int,
    duration_us: float,
    session_rate_rps: Optional[float] = None,
    session_times: Optional[Sequence[float]] = None,
    mean_turns: float = 3.0,
    think_us: float = 2_000.0,
    first_prompt_tokens: int = 48,
    next_prompt_tokens: int = 12,
    decode_tokens: int = 8,
    vocab: int = 50_257,
    session_prefix: str = "u",
) -> List[Tuple[float, bytes]]:
    """Build a ``(t_us, payload)`` request trace over a session population.

    Exactly one of ``session_rate_rps`` (homogeneous arrivals) and
    ``session_times`` (precomputed, e.g. a flash-crowd curve from
    :mod:`repro.workloads.arrivals`) selects the arrival process.  Per
    session, draws follow in a fixed order: turn count (geometric with
    mean ``mean_turns``), then per turn the think gap (exponential),
    prompt length (Poisson around the per-turn mean, ≥1) and decode
    length (Poisson around ``decode_tokens``, ≥1), then the prompt token
    ids themselves.  Requests past ``duration_us`` are dropped — a turn
    the window never reaches.
    """
    rng = np.random.default_rng(seed)
    if (session_rate_rps is None) == (session_times is None):
        raise ValueError(
            "exactly one of session_rate_rps / session_times is required")
    if session_times is None:
        starts = poisson_times(rng, session_rate_rps, duration_us)
    else:
        starts = np.asarray(session_times, dtype=float)
    trace: List[Tuple[float, bytes]] = []
    p_stop = 1.0 / max(mean_turns, 1.0)
    for i, t0 in enumerate(starts):
        sid = f"{session_prefix}{i}"
        n_turns = int(rng.geometric(p_stop))
        t = float(t0)
        for turn in range(n_turns):
            if turn > 0:
                t += float(rng.exponential(think_us))
            if t >= duration_us:
                break
            mean_prompt = first_prompt_tokens if turn == 0 else next_prompt_tokens
            n_prompt = max(1, int(rng.poisson(mean_prompt)))
            n_decode = max(1, int(rng.poisson(decode_tokens)))
            prompt = rng.integers(0, vocab, size=n_prompt).tolist()
            payload = json.dumps({"session": sid, "prompt": prompt,
                                  "n": n_decode}).encode()
            trace.append((t, payload))
    trace.sort(key=lambda e: e[0])
    return trace
