"""The one generator that reads every traffic mix (``<mix>.json`` beside
this file).

Two kinds of mix:

* ``sessions``: multi-turn sessions for the token server, after the
  session structure of ``repro_torch/workloads/llm.py`` (a geometric
  number of turns a session, a long first prompt, shorter follow-ups),
  with the sizes that the mix file states.  ``concurrent`` sessions
  are open at once and their requests are taken round-robin; a session
  ends after its turns, or before a turn that would take its history
  (every prompt and reply token so far) past ``max_history``, and a new
  one opens in its place.  The server's replies have exactly the asked
  length, so the history is known here without the model.
* ``train``: the seeded batches of ``repro_torch/data/pipeline.py``
  (piecewise-linear token walks with 10% noise), a pure function of
  (seed, step).

Sizes are drawn by strata: each block of ``strata`` draws of one
distribution takes the quantiles at (i + 0.5) / strata, i = 0 ..
strata - 1, in an order the seed permutes.  Every seed then sees the same
sizes in another order, so seeds change the order of the work and not
its amount.  Token ids come from a stream of their own.  The same seed
gives the same trace, bit for bit.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path
from statistics import NormalDist
from typing import Dict, Iterator, List

import numpy as np

HERE = Path(__file__).resolve().parent


def load_mix(name: str) -> Dict:
    return json.loads((HERE / f"{name}.json").read_text())


def _rng(seed: int, stream: str) -> np.random.Generator:
    words = [int(b) for b in stream.encode()]
    return np.random.default_rng(np.random.SeedSequence([int(seed), *words]))


def quantile(spec: Dict, u: float) -> int:
    """The ``u`` quantile of a size distribution, clipped and rounded."""
    dist = spec["dist"]
    if dist == "fixed":
        return int(spec["value"])
    if dist == "geometric":
        p = 1.0 / spec["mean"]
        return max(1, math.ceil(math.log1p(-u) / math.log1p(-p)))
    if dist == "lognormal":
        z = NormalDist().inv_cdf(u)
        v = spec["median"] * math.exp(spec["sigma"] * z)
        return int(min(max(round(v), spec["min"]), spec["max"]))
    raise ValueError(f"unknown distribution {dist!r}")


def largest(spec: Dict) -> int:
    """The largest size a distribution gives (None for the unbounded
    geometric)."""
    return spec["value"] if spec["dist"] == "fixed" else spec.get("max")


class Strata:
    """An endless stream of sizes from ``spec``, block by block."""

    def __init__(self, spec: Dict, rng: np.random.Generator):
        self.spec, self.rng = spec, rng
        self.block: List[int] = []

    def __next__(self) -> int:
        if not self.block:
            k = int(self.spec.get("strata", 1))
            self.block = [quantile(self.spec, (i + 0.5) / k)
                          for i in self.rng.permutation(k)]
        return self.block.pop()


@dataclass(frozen=True)
class Request:
    slot: int            # the client slot, 0 .. concurrent - 1
    session: str
    prompt: List[int]    # the turn's new tokens
    n: int               # tokens to generate
    context: int         # tokens of the session's history before the turn


def session_requests(mix: Dict, vocab: int, seed: int) -> Iterator[Request]:
    """The requests of a ``sessions`` mix, in the order they are sent."""
    size_rng = _rng(seed, "sizes")
    tok_rng = _rng(seed, "tokens")
    turns = Strata(mix["turns"], size_rng)
    first = Strata(mix["first_prompt"], size_rng)
    nxt = Strata(mix.get("next_prompt", mix["first_prompt"]), size_rng)
    out = Strata(mix["output"], size_rng)
    limit = mix["max_history"]
    opened = 0
    slots = []

    def open_session():
        nonlocal opened
        opened += 1
        return {"id": f"s{opened - 1}", "turns": next(turns), "done": 0,
                "hist": 0}

    for _ in range(mix["concurrent"]):
        slots.append(open_session())
    while True:
        for i, s in enumerate(slots):
            while True:
                if s["done"] < s["turns"]:
                    n_prompt = next(first) if s["done"] == 0 else next(nxt)
                    n = next(out)
                    if s["done"] == 0 or s["hist"] + n_prompt + n <= limit:
                        break
                s = slots[i] = open_session()
            prompt = tok_rng.integers(0, vocab, size=n_prompt).tolist()
            yield Request(i, s["id"], prompt, n, s["hist"])
            s["hist"] += n_prompt + n
            s["done"] += 1


def train_batch(mix: Dict, vocab: int, seed: int, step: int
                ) -> Dict[str, np.ndarray]:
    """Step ``step``'s batch of a ``train`` mix: ``inputs`` and
    ``targets``, (batch, seq) int32, the targets the inputs shifted by
    one.  Every row of every step differs."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), step, 0]))
    B, S = mix["batch"], mix["seq"]
    base = rng.integers(0, vocab, size=(B, 1))
    stride = rng.integers(1, 17, size=(B, 1))
    ramp = (base + stride * np.arange(S + 1)[None, :]) % vocab
    noise = rng.integers(0, vocab, size=(B, S + 1))
    mask = rng.random((B, S + 1)) < 0.1
    toks = np.where(mask, noise, ramp).astype(np.int32)
    return {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
