"""The decode step as graphs (``launch.serve.StepGraphs``), on the CPU.

A decode step takes its position as a 0-d tensor on the device and gives
the int position's bits; ``weak_scalar`` rounds as ``torch.tensor`` did.
The graphs' segmenting runs here with ``GraphStandIn`` in the place of
``torch.cuda.CUDAGraph``: it records every operator run between
``capture_begin`` and ``capture_end`` and runs them again on the same
tensors at ``replay``, and, as a CUDA capture does, it refuses what reads a
tensor back to the host or makes one from host data.  The card's half of
these checks is ``chip_smoke.py``'s phase 14."""

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs import get_smoke_config, list_archs
from repro_torch.launch import serve
from repro_torch.models import transformer
from repro_torch.models.common import init_params, weak_scalar
from repro_torch.models.transformer import decode_step, prefill
from repro_torch.runtime.server import ReplicatedServer

torch.set_num_threads(2)

ARCHS = list_archs()
MOE_ARCHS = [a for a in ARCHS if get_smoke_config(a).moe is not None]
MAX_SEQ = 40
PROMPT = [5, 6, 7, 8, 9]
STEPS = 24                  # past the smoke configs' 16-slot rings

aten = torch.ops.aten
#: what a CUDA capture cannot hold: a read back to the host, a tensor made
#: from host data (a copy from the host), a shape that depends on the data
REFUSED = {aten._local_scalar_dense.default, aten.lift_fresh.default,
           aten.nonzero.default, aten.masked_select.default}


class _Recorder(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in REFUSED:
            raise RuntimeError(f"{func} in a captured region")
        out = func(*args, **kwargs)
        self.ops.append((func, args, kwargs, out))
        return out


class GraphStandIn:
    """``torch.cuda.CUDAGraph``'s capture and replay on the CPU: the
    operators of the captured region, run again in order on the tensors
    they ran on.  An operator that writes its arguments runs again; a view
    stays the view it was; any other operator's fresh outputs are copied
    into the tensors the capture made, which later operators read."""

    def capture_begin(self, pool=None):
        self.mode = _Recorder()
        self.mode.__enter__()

    def capture_end(self):
        self.mode.__exit__(None, None, None)

    def pool(self):
        return None

    def replay(self):
        for func, args, kwargs, out in self.mode.ops:
            schema = func._schema
            if schema.is_mutable:
                func(*args, **kwargs)
            elif not any(r.alias_info is not None for r in schema.returns):
                for o, n in zip(tree_leaves(out),
                                tree_leaves(func(*args, **kwargs))):
                    o.copy_(n)


@pytest.fixture
def graphed(monkeypatch):
    """Decoders built inside capture their steps, with the stand-in."""
    monkeypatch.setattr(serve, "graphs_engage", lambda model: True)
    monkeypatch.setattr(serve, "CUDAGraph", GraphStandIn)


def _model(arch: str):
    return init_params(get_smoke_config(arch),
                       torch.Generator().manual_seed(0))


def _eager(model, hist, n):
    """The eager greedy decode: tokens and the caches it leaves."""
    logits, caches = prefill(model, torch.tensor([hist]), max_seq=MAX_SEQ)
    tok = torch.argmax(logits, -1)
    out = [int(tok[0])]
    for i in range(n - 1):
        logits, caches = decode_step(model, caches, tok, len(hist) + i)
        tok = torch.argmax(logits, -1)
        out.append(int(tok[0]))
    return out, caches


def _leaves(caches):
    return [st[k] for group in caches for st in group for k in sorted(st)]


@pytest.mark.parametrize("arch", ARCHS)
def test_device_position_gives_the_int_positions_bits(arch):
    """Steps at a 0-d position tensor advanced in place give the logits
    and caches of int positions, bit for bit, through steps that wrap the
    window layers' rings; each ring slot then holds the last position
    written there (-1 where none was)."""
    model = _model(arch)
    logits, caches = prefill(model, torch.tensor([PROMPT]), max_seq=MAX_SEQ)
    a = caches
    b = tuple(tuple({k: t.clone() for k, t in st.items()} for st in g)
              for g in caches)
    tok_a = tok_b = torch.argmax(logits, -1)
    pos = torch.full((), len(PROMPT), dtype=torch.int64)
    for i in range(STEPS):
        la, a = decode_step(model, a, tok_a, len(PROMPT) + i)
        lb, b = decode_step(model, b, tok_b, pos)
        pos.add_(1)
        assert torch.equal(la, lb)
        assert all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))
        tok_a, tok_b = torch.argmax(la, -1), torch.argmax(lb, -1)
    last = len(PROMPT) + STEPS - 1
    for group in b:
        for st in group:
            if "pos" not in st:
                continue
            size = st["pos"].shape[-1]
            want = torch.tensor([max((p for p in range(last + 1)
                                      if p % size == j), default=-1)
                                 for j in range(size)], dtype=torch.int32)
            assert torch.equal(st["pos"], want.expand_as(st["pos"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_graphed_decoder_gives_the_eager_tokens_and_caches(arch, graphed):
    """One capture serves every call: the tokens of the eager decode, and
    after the last call its caches, bit for bit; every decode step is a
    replay."""
    model = _model(arch)
    decoder = serve.GreedyDecoder(model, MAX_SEQ)
    calls = [(PROMPT, STEPS + 1), ([3, 1, 4], 4), (PROMPT + [2, 7], 9)]
    for hist, n in calls:
        want, caches = _eager(model, hist, n)
        assert decoder("s", hist, n) == want
    assert decoder.captures == 1
    assert decoder.replayed_steps == sum(n - 1 for _, n in calls)
    assert len(decoder.timings) == len(calls)
    got = _leaves(decoder.graphs.caches)
    assert all(torch.equal(x, y) for x, y in zip(got, _leaves(caches)))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_routed_ffn_runs_between_the_graphs_by_its_module_name(arch,
                                                               graphed,
                                                               monkeypatch):
    """A routed model's step is one graph a routed layer and one more; a
    wrapper put at ``transformer.moe_ffn`` after the capture is called once
    a routed layer a replayed step (and once a routed layer a prefill),
    and the replicated server serves the eager tokens."""
    model = _model(arch)
    n_layers = sum(map(model.cfg.routed, model.cfg.layer_list()))
    requests = [("s0", PROMPT, 6), ("s1", [3, 1, 4], 4), ("s0", [2, 7], 5)]
    hist, want = {}, []
    for sid, prompt, n in requests:        # each session's eager tokens
        h = hist.setdefault(sid, [])
        h.extend(prompt)
        want.append(_eager(model, h, n)[0])
        h.extend(want[-1])
    decoder = serve.GreedyDecoder(model, MAX_SEQ)
    server = ReplicatedServer.build(decoder)
    client = server.cluster.new_client()
    sid, prompt, n = requests[0]
    assert server.generate(client, sid, prompt, n)[0] == want[0]
    assert len(decoder.graphs.graphs) == n_layers + 1
    assert len(decoder.graphs.cuts) == n_layers

    seen = []
    inner = transformer.moe_ffn

    def counted(cfg, p, x, ctx=None):
        seen.append(tuple(x.shape[:2]))
        return inner(cfg, p, x, ctx)

    monkeypatch.setattr(transformer, "moe_ffn", counted)
    for (sid, prompt, n), toks in zip(requests[1:], want[1:]):
        assert server.generate(client, sid, prompt, n)[0] == toks
    steps = 3 * sum(n - 1 for _, _, n in requests[1:])  # three replicas
    assert seen.count((1, 1)) == steps * n_layers
    assert len(seen) == steps * n_layers + 3 * len(requests[1:]) * n_layers
    assert decoder.captures == 1
    assert decoder.replayed_steps == 3 * sum(n - 1 for _, _, n in requests)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_weak_scalar_rounds_as_torch_tensor(dtype):
    like = torch.zeros(2, dtype=dtype)
    g = torch.Generator().manual_seed(3)
    values = ([float(d) ** 0.5 for d in (16, 64, 1152, 2048, 2560, 4096,
                                         5120, 8192)]
              + (torch.randn(2000, generator=g, dtype=torch.float64)
                 * 1e3).tolist() + [1 / 3, 0.1, 1e-8, 65504.0, 1e38])
    bits = {2: torch.int16, 4: torch.int32}[like.element_size()]
    for v in values:
        got = weak_scalar(v, like)
        assert got.dtype == dtype and got.shape == ()
        assert torch.equal(got.view(bits),
                           torch.tensor(v, dtype=dtype).view(bits)), v


@pytest.mark.parametrize("body", ["item", "host_tensor", "index_by_int"])
def test_stand_in_refuses_what_a_capture_cannot_hold(body):
    """A read back to the host, a tensor made from host data and a Python
    int written into a tensor each fail inside a stand-in capture, as the
    parent's embedding scale and cache writes would have."""
    x = torch.zeros(4)
    run = {"item": lambda: int(x.sum()),
           "host_tensor": lambda: torch.tensor(2.0) * x,
           "index_by_int": lambda: x.__setitem__(1, 3)}[body]
    g = GraphStandIn()
    g.capture_begin()
    try:
        with pytest.raises(RuntimeError, match="captured region"):
            run()
    finally:
        g.capture_end()
