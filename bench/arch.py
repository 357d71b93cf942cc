"""The architecture seam: a configuration's layers and the reference module
that knows them, read from the model's fields as the harness builds them
(``harness.model_fields``).

* ``model["blocks"]``: the program's pattern program, ``[[pattern, reps],
  ...]``, each pattern a list of layers, each layer a dict of the
  program's ``LayerSpec`` fields (``{"kind": "attn", "window": 128}``);
* ``model["layers"]``: the same, one dict a layer in order;
* ``model["reference"]``: the module ``bench/reference/<name>.py`` that
  holds the architecture's leaves, layer, head, loss and work counts.

A model without these keys (a configuration's ``model`` section read
alone) is today's: every layer full attention, one group, the Qwen3
reference (``bench/reference/model.py``).
"""

from __future__ import annotations

import importlib
from types import ModuleType
from typing import Dict, List

DEFAULT = "model"


def module(model: Dict) -> ModuleType:
    """The reference module that ``model`` names."""
    return importlib.import_module(
        f"bench.reference.{model.get('reference', DEFAULT)}")


def blocks(model: Dict) -> List:
    return model.get("blocks") or [[[{"kind": "attn"}], model["n_layers"]]]


def layers(model: Dict) -> List[Dict]:
    return model.get("layers") or [
        dict(spec) for pattern, reps in blocks(model)
        for _ in range(reps) for spec in pattern]


def layer_index(model: Dict, group: int, pos: int) -> List[int]:
    """The layers of pattern position ``pos`` of group ``group``: those
    that the program stacks into one leaf, in the order it stacks them."""
    bl = blocks(model)
    offset = sum(len(p) * r for p, r in bl[:group])
    width, reps = len(bl[group][0]), bl[group][1]
    return [offset + r * width + pos for r in range(reps)]
