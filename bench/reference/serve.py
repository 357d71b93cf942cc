"""The served tokens held against the reference.

Each checked sequence is a history the server built: its token ids, the
calls that the routed layers ran them in (``segments``) and the
positions whose logits picked a served token.  The reference runs every
sequence through the layers in fp32, one layer at a time (each drawn
again from the seed, so that it fits beside the hidden states), and reads
at each such position the gap by which the served token's logit lies
below its best.  With ``control``, the same pass in fp8 (``model.fp8``)
gives the gap of the token that the lower precision puts first."""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from bench import weights
from bench.reference import fingerprint, model as ref

Seq = Dict[str, object]   # tokens, segments, checks [(position, token)]


@torch.no_grad()
def check(model: Dict, seed: int, device, seqs: Sequence[Seq],
          control: bool = False) -> Dict[str, float]:
    ref.exact_fp32()
    f32 = torch.float32
    table = weights.draw(model, seed, "embed", -1, device, f32)
    out_norm = weights.draw(model, seed, "out_norm", -1, device, f32)
    w_head = (table.T if model["tie_embeddings"]
              else weights.draw(model, seed, "lm_head", -1, device, f32))
    xs = [ref.embed(model, table, torch.tensor(s["tokens"], device=device))
          for s in seqs]
    xq = [x.clone() for x in xs] if control else None
    for l in range(model["n_layers"]):
        p = {name: weights.draw(model, seed, name, l, device, f32)
             for name in weights.layer_specs(model)}
        for i, s in enumerate(seqs):
            xs[i] = ref.layer(model, p, xs[i][None], s["segments"])[0]
            if control:
                xq[i] = ref.layer(model, p, xq[i][None], s["segments"],
                                  quant="fp8")[0]
        del p
    gaps: List[float] = []
    ctrl: List[float] = []
    missed = 0
    for i, s in enumerate(seqs):
        pos = torch.tensor([c[0] for c in s["checks"]], device=device)
        tok = torch.tensor([c[1] for c in s["checks"]], device=device)
        lg = ref.logits(model, w_head, out_norm, xs[i][pos])
        best = lg.max(-1).values
        gaps.extend((best - lg.gather(1, tok[:, None])[:, 0]).tolist())
        missed += int((lg.argmax(-1) != tok).sum())
        if control:
            lq = ref.logits(model, w_head, out_norm, xq[i][pos], "fp8")
            pick = lq.argmax(-1)
            ctrl.extend((best - lg.gather(1, pick[:, None])[:, 0]).tolist())
    out = {"max_logit_gap": max(gaps), "tokens_checked": len(gaps),
           "tokens_not_argmax": missed}
    if control:
        out["control_max_logit_gap"] = max(ctrl)
    return out


@torch.no_grad()
def weights_digest(model: Dict, seed: int, device) -> int:
    """The digest of the benchmark's weights in the program's leaf order
    (the pytree's: sorted keys, each layer leaf stacked over the layers),
    drawn again from the seed."""
    names = ["embed"] + sorted(weights.layer_specs(model))
    if not model["tie_embeddings"]:
        names.append("lm_head")
    names.append("out_norm")
    leaf = []
    for name in names:
        if name in weights.layer_specs(model):
            leaf.append(sum(fingerprint.digest(
                weights.draw(model, seed, name, l, device))
                for l in range(model["n_layers"])) & fingerprint.M32)
        else:
            leaf.append(fingerprint.digest(
                weights.draw(model, seed, name, -1, device)))
    return fingerprint.fold(leaf)
