"""The served tokens held against the reference.

Each checked sequence is a history the server built: its token ids, the
calls that the routed layers ran them in (``segments``) and the
positions whose logits picked a served token.  The reference runs every
sequence through the layers in fp32, one layer at a time (each drawn
again from the seed, so that it fits beside the hidden states), and reads
at each such position the gap by which the served token's logit lies
below its best.  With ``control``, the same pass in fp8 (``model.fp8``)
gives the gap of the token that the lower precision puts first.  Beside
the widest gap it reads the share of gaps past a threshold, which a rare
routing flip does not swamp: such a flip moves one bf16 token about as
far as fp8 moves many.  The layers, leaves and head are those of the
configuration's reference module (``bench/arch.py``)."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from bench import arch, weights
from bench.reference import fingerprint, model as base

Seq = Dict[str, object]   # tokens, segments, checks [(position, token)]


def gap_share(gaps: Sequence[float], tau: float) -> float:
    """The share of ``gaps`` above ``tau`` (0 to 1)."""
    return sum(g > tau for g in gaps) / len(gaps)


def check(model: Dict, seed: int, device, seqs: Sequence[Seq],
          control: bool = False, tau: Optional[float] = None
          ) -> Dict[str, float]:
    """The widest gap, the tokens checked and those off the reference's
    argmax, and given ``tau`` the share of gaps past it; with ``control``
    the control's widest gap and share too."""
    got, ctrl, missed = gaps(model, seed, device, seqs, control)
    out = {"max_logit_gap": max(got), "tokens_checked": len(got),
           "tokens_not_argmax": missed}
    if control:
        out["control_max_logit_gap"] = max(ctrl)
    if tau is not None:
        out["gap_share"] = gap_share(got, tau)
        if control:
            out["control_gap_share"] = gap_share(ctrl, tau)
    return out


@torch.no_grad()
def gaps(model: Dict, seed: int, device, seqs: Sequence[Seq],
         control: bool = False) -> Tuple[List[float], List[float], int]:
    """The gap of every checked token, the control's gap at each (empty
    without ``control``), and the number of checked tokens that are not
    the reference's argmax."""
    base.exact_fp32()
    ref = arch.module(model)
    f32 = torch.float32
    g = {name: weights.draw(model, seed, name, -1, device, f32)
         for name in weights.global_specs(model)}
    out_norm, w_head = g["out_norm"], ref.head(model, g)
    xs = [ref.embed(model, g["embed"],
                    torch.tensor(s["tokens"], device=device)) for s in seqs]
    xq = [x.clone() for x in xs] if control else None
    for l in range(model["n_layers"]):
        p = {name: weights.draw(model, seed, name, l, device, f32)
             for name in weights.layer_specs(model, l)}
        for i, s in enumerate(seqs):
            xs[i] = ref.layer(model, p, xs[i][None], s["segments"],
                              index=l)[0]
            if control:
                xq[i] = ref.layer(model, p, xq[i][None], s["segments"],
                                  quant="fp8", index=l)[0]
        del p
    got: List[float] = []
    ctrl: List[float] = []
    missed = 0
    for i, s in enumerate(seqs):
        pos = torch.tensor([c[0] for c in s["checks"]], device=device)
        tok = torch.tensor([c[1] for c in s["checks"]], device=device)
        lg = ref.logits(model, w_head, out_norm, xs[i][pos])
        best = lg.max(-1).values
        got.extend((best - lg.gather(1, tok[:, None])[:, 0]).tolist())
        missed += int((lg.argmax(-1) != tok).sum())
        if control:
            lq = ref.logits(model, w_head, out_norm, xq[i][pos], "fp8")
            pick = lq.argmax(-1)
            ctrl.extend((best - lg.gather(1, pick[:, None])[:, 0]).tolist())
    return got, ctrl, missed


@torch.no_grad()
def weights_digest(model: Dict, seed: int, device) -> int:
    """The digest of the benchmark's weights in the program's leaf order
    (the pytree's: ``embed``, then each group's pattern positions in
    order, each position's leaves by sorted name, stacked over the layers
    it holds, then ``lm_head`` where untied and ``out_norm``), drawn again
    from the seed."""
    def one(name: str) -> int:
        return fingerprint.digest(weights.draw(model, seed, name, -1, device))

    leaf = [one("embed")]
    for g, (pattern, _) in enumerate(arch.blocks(model)):
        for pos in range(len(pattern)):
            layers = arch.layer_index(model, g, pos)
            for name in sorted(weights.layer_specs(model, layers[0])):
                leaf.append(sum(fingerprint.digest(
                    weights.draw(model, seed, name, l, device))
                    for l in layers) & fingerprint.M32)
    if not model["tie_embeddings"]:
        leaf.append(one("lm_head"))
    leaf.append(one("out_norm"))
    return fingerprint.fold(leaf)
