"""Each mix's trace repeats bit for bit for a seed and differs across
seeds; the strata give every seed the same sizes."""

import itertools

import numpy as np
import pytest

from bench.traffic import generator

SEEDS = (7, 2 ** 31 + 99)
# the mixes on file, and a multi-turn mix of four interleaved sessions
# that a later cell may bring, so that the session structure is held too
MULTI = {"kind": "sessions", "concurrent": 4,
         "turns": {"dist": "geometric", "mean": 8, "strata": 8},
         "first_prompt": {"dist": "lognormal", "median": 2048, "sigma": 0.6,
                          "min": 512, "max": 6144, "strata": 8},
         "next_prompt": {"dist": "lognormal", "median": 96, "sigma": 0.6,
                         "min": 16, "max": 512, "strata": 16},
         "output": {"dist": "lognormal", "median": 8, "sigma": 0.6,
                    "min": 2, "max": 24, "strata": 16},
         "max_history": 8192}
SESSION_MIXES = ("decode", "multi-turn")


def _mix(name):
    return MULTI if name == "multi-turn" else generator.load_mix(name)


def _requests(mix, seed, n=120):
    return list(itertools.islice(
        generator.session_requests(_mix(mix), 151936, seed), n))


@pytest.mark.parametrize("mix", SESSION_MIXES)
def test_sessions_repeat_for_a_seed_and_differ_across_seeds(mix):
    a, b = _requests(mix, SEEDS[0]), _requests(mix, SEEDS[0])
    assert a == b
    c = _requests(mix, SEEDS[1])
    assert [r.prompt for r in a] != [r.prompt for r in c]
    if _mix(mix)["output"]["dist"] != "fixed":
        assert [(r.n, len(r.prompt)) for r in a] != [
            (r.n, len(r.prompt)) for r in c]


@pytest.mark.parametrize("mix", SESSION_MIXES)
def test_sessions_keep_the_history_limit_and_the_sizes(mix):
    m = _mix(mix)
    reqs = _requests(mix, SEEDS[1], 600)
    hist = {}
    for r in reqs:
        assert r.context == hist.get(r.session, 0)
        hist[r.session] = r.context + len(r.prompt) + r.n
        assert hist[r.session] <= m["max_history"]
        assert 1 <= r.n <= generator.largest(m["output"])
    # round-robin over the concurrent slots
    assert [r.slot for r in reqs[:8]] == [i % m["concurrent"]
                                          for i in range(8)]
    # each block of strata holds the same sizes whatever the seed
    k = m["output"].get("strata", 1)
    outs = [sorted(r.n for r in _requests(mix, s, 600)[:k]) for s in SEEDS]
    assert outs[0] == outs[1]


def test_train_batches_repeat_and_differ():
    m = generator.load_mix("train")
    a = generator.train_batch(m, 151936, SEEDS[0], 3)
    b = generator.train_batch(m, 151936, SEEDS[0], 3)
    c = generator.train_batch(m, 151936, SEEDS[1], 3)
    d = generator.train_batch(m, 151936, SEEDS[0], 4)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["inputs"], c["inputs"])
    assert not np.array_equal(a["inputs"], d["inputs"])
    assert a["inputs"].shape == (m["batch"], m["seq"])
    assert np.array_equal(a["inputs"][:, 1:], a["targets"][:, :-1])
    assert not np.array_equal(a["inputs"][0], a["inputs"][1])


def test_lognormal_strata_are_the_quantiles():
    spec = {"dist": "lognormal", "median": 100, "sigma": 0.6, "min": 1,
            "max": 10 ** 6, "strata": 2}
    assert generator.quantile(spec, 0.5) == 100
    s = generator.Strata(spec, np.random.default_rng(0))
    got = sorted([next(s), next(s)])
    assert got == [round(100 * np.exp(0.6 * z)) for z in (-0.6744897501960817,
                                                          0.6744897501960817)]
