"""Sharding rules, ported from ``repro.parallel.sharding``: parameter, batch
and cache specs per mesh, and their placement as DTensors.

Axes:
  pod    — data parallelism across pods (multi-pod mesh only)
  data   — data parallelism + FSDP (params' non-model dim sharded here)
  model  — tensor parallelism: heads / FFN / experts / vocab; also the
           sequence axis of decode KV caches (flash-decode style)

A spec is JAX's ``PartitionSpec`` as a plain tuple, one entry per tensor
dimension: ``None`` (not sharded), an axis name, or a tuple of axis names
(the dimension split over several axes, the first the major one).  The
rules are name-based over the parameter tree and read a leaf's path as the
reference reads its pytree path (``Transformer.leaf_items``): the leaf's
own key, and whether it sits in ``groups``, whose stacked leaves get a
leading ``None``.  A mesh here is anything with ``mesh_dim_names`` and
``shape`` (a ``DeviceMesh``); the rules read nothing else.

``placements`` turns a spec into DTensor placements, one per mesh
dimension; ``distribute_tree`` (the reference's ``named`` plus its
``device_put``) places a model, a list of leaves or a nest of caches.

``columns`` and ``rows`` run a layer's products on local shards, as the
reference's compiled program runs them: each weight gathered over the
data axes (its gradient reduce-scattered back), column-cut products on
inputs whole over "model", each row-cut product followed by one
reduction over "model".  They fix the per-device work of the sharded
program, which DTensor's propagation would otherwise choose (and choose
differently between torch versions).
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.models.common import ModelConfig, Transformer

FSDP = "data"
TP = "model"

Spec = Tuple[Any, ...]


def axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def shard_ctx_for_mesh(mesh):
    from repro_torch.models.transformer import ShardCtx
    return ShardCtx(mesh=mesh, dp_axes=dp_axes(mesh), tp_axis=TP)


def _rule_for(name: str, shape: Tuple[int, ...], cfg: Optional[ModelConfig],
              stacked: bool) -> Spec:
    """Spec for one parameter by name (``shape`` includes the stacked
    axis when ``stacked``)."""
    r = len(shape) - (1 if stacked else 0)
    base: Tuple = ()
    if name == "embed":
        base = (TP, FSDP)
    elif name == "lm_head":
        base = (FSDP, TP)
    elif name in ("wq", "wk", "wv", "up", "w_in", "wz", "wi", "wf",
                  "wo_gate"):
        base = (FSDP, TP) if r == 2 else (None,)
    elif name in ("wo", "down"):
        base = (TP, FSDP)
    elif name in ("w_gate", "w_up"):
        base = (TP, FSDP, None) if r == 3 else (FSDP, TP)   # moe vs dense
    elif name == "w_down":
        base = (TP, None, FSDP) if r == 3 else (TP, FSDP)
    elif name == "router":
        base = (FSDP, None)
    elif name in ("wa", "wx", "w_out"):
        base = (TP, FSDP)
    elif name == "conv":
        base = (None, TP)
    elif name == "lam":
        base = (TP,)
    else:   # ln*, norms, biases, rz, bf — replicate
        base = tuple(None for _ in range(r))
    base = tuple(base[:r]) + tuple(None for _ in range(r - len(base)))
    if stacked:
        base = (None,) + base
    return base


def _divisible(spec: Spec, shape: Tuple[int, ...], mesh) -> Spec:
    """Drop sharding on axes the shape does not divide evenly (tiny smoke
    configs; odd head counts)."""
    sizes = axis_sizes(mesh)
    fixed = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if ax is None:
            fixed.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        n = math.prod(sizes[a] for a in axes)
        fixed.append(ax if dim % n == 0 else None)
    return tuple(fixed)


def weight_compute_spec(name: str, shape: Tuple[int, ...], mesh) -> Spec:
    """Compute-time spec for a weight: the storage rule with the FSDP axis
    dropped (ZeRO-3 style per-layer gather: the small weight is gathered
    over ``data`` instead of the large activations being reduced)."""
    spec = _rule_for(name, shape, None, stacked=False)
    fixed = tuple(None if ax == FSDP else ax for ax in spec)
    return _divisible(fixed, shape, mesh)


def param_pspecs(cfg: ModelConfig, model: Transformer, mesh) -> List[Spec]:
    """Specs of ``model``'s parameters in ``leaf_items`` order."""
    specs = []
    for path, leaf in model.leaf_items():
        spec = _rule_for(path[-1], tuple(leaf.shape), cfg,
                         stacked=path[0] == "groups")
        specs.append(_divisible(spec, tuple(leaf.shape), mesh))
    return specs


def batch_pspecs(cfg: ModelConfig, mesh) -> Dict[str, Spec]:
    dp = dp_axes(mesh)
    return {"inputs": (dp,), "targets": (dp,)}


def cache_pspecs(cfg: ModelConfig, caches: Any, mesh,
                 seq_shard: bool = True) -> Any:
    """Decode caches, nested as ``caches``: batch over dp; the KV cache's
    sequence axis over ``model`` (flash-decode / context-parallel decode)
    when divisible."""
    dp = dp_axes(mesh)

    def rule(name, shape):
        # stacked leading reps dim, then batch
        if name in ("k", "v"):      # (R, B, S, KV, dh)
            spec = (None, dp, TP if seq_shard else None, None, None)
        elif name == "pos":         # (R, S)
            spec = (None, TP if seq_shard else None)
        elif name == "C":           # (R, B, H, dh, dh)
            spec = (None, dp, None, None, None)
        elif name in ("n", "c", "h", "m"):   # (R, B, H, dh) / (R, B, H)
            spec = (None, dp) + (None,) * (len(shape) - 2)
        elif name == "y":           # (R, B, W)
            spec = (None, dp, TP)
        elif name == "conv":        # (R, B, 3, W)
            spec = (None, dp, None, TP)
        else:
            spec = (None,) * len(shape)
        return _divisible(spec, shape, mesh)

    def walk(tree, name=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(walk(v) for v in tree)
        return rule(name, tuple(tree.shape))

    return walk(caches)


# ---------------------------------------------------------------------------
# Specs as DTensor placements
# ---------------------------------------------------------------------------
def placements(spec: Spec, mesh) -> Tuple:
    """One placement per mesh dimension: ``Shard(d)`` where the spec puts
    that axis on tensor dimension ``d``, else ``Replicate()``.  A dimension
    split over several axes is split by them in mesh order, the first the
    major one, as JAX splits it; so their order in the spec must be the
    mesh's.  An axis of size 1 gives ``Replicate()``: a cut into one piece
    is no cut, and DTensor cannot reshape a dimension of size 1 that is
    marked as cut."""
    names = tuple(mesh.mesh_dim_names)
    where = {}
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec {spec}: axes {axes} of dimension {d} are "
                             f"not in mesh order {names}")
        for a in axes:
            if a in where:
                raise ValueError(f"spec {spec} uses axis {a!r} twice")
            where[a] = d
    sizes = axis_sizes(mesh)
    return tuple(Shard(where[a]) if a in where and sizes[a] > 1
                 else Replicate() for a in names)


def place(x: torch.Tensor, mesh, spec: Spec) -> DTensor:
    """``x`` laid out on ``mesh`` by ``spec``: a DTensor is redistributed;
    a plain tensor, which every rank holds whole, is cut without
    communication."""
    pl = placements(spec, mesh)
    if isinstance(x, DTensor):
        return x.redistribute(mesh, pl)
    return distribute_tensor(x, mesh, pl, src_data_rank=None)


def whole(x: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered into the whole tensor on every rank (a
    collective); a plain tensor as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def distribute_tree(mesh, tree: Any, specs: Any) -> Any:
    """Place ``tree`` on ``mesh`` by ``specs``: a ``Transformer`` (its
    parameters replaced in ``leaf_items`` order by DTensor parameters; the
    model is returned), a list of leaves with a list of specs, or a nest of
    dicts and tuples (caches) with specs nested alike."""
    if isinstance(tree, Transformer):
        for (path, p), spec in zip(list(tree.leaf_items()), specs):
            tree.set_leaf(path, nn.Parameter(place(p.detach(), mesh, spec),
                                             requires_grad=p.requires_grad))
        return tree
    if isinstance(tree, dict):
        return {k: distribute_tree(mesh, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(distribute_tree(mesh, v, s)
                          for v, s in zip(tree, specs))
    return place(tree, mesh, specs)


def elementwise(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` (elementwise) of ``x``; of a DTensor, applied to its local
    shard once its partial sums are taken.  For ``F.logsigmoid``, which
    reaches DTensor as ``log_sigmoid_forward`` under a fake mode (a traced
    step, ``launch.costing``), an operator DTensor has no rule for; a run
    gives the same bits either way."""
    if not isinstance(x, DTensor):
        return fn(x)
    if any(pl.is_partial() for pl in x.placements):
        x = x.redistribute(x.device_mesh, [Replicate() if pl.is_partial()
                                           else pl for pl in x.placements])
    return DTensor.from_local(fn(x.to_local()), x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def global_offset(x: DTensor) -> Tuple[int, ...]:
    """The global index of the first element of ``x``'s local shard, in
    each dimension.  Worked out ``host_side``: DTensor reads the mesh
    coordinate from a tensor, which a traced step could not read."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    from repro_torch.kernels.ops import host_side
    with host_side():
        return tuple(compute_local_shape_and_global_offset(
            x.shape, x.device_mesh, x.placements)[1])


def unflatten(x: torch.Tensor, dim: int, sizes: Tuple[int, ...]
              ) -> torch.Tensor:
    """``x`` with dimension ``dim`` split into ``sizes`` (a reshape).  A
    DTensor whose dimension ``dim`` is cut over more ranks than
    ``sizes[0]`` divides by is first made whole along it (DTensor cannot
    split a dimension that way)."""
    dim %= x.ndim
    if isinstance(x, DTensor):
        cut = math.prod(x.device_mesh.size(i) for i, pl in
                        enumerate(x.placements) if pl.is_shard(dim))
        if sizes[0] % cut:
            x = x.redistribute(x.device_mesh, [
                Replicate() if pl.is_shard(dim) else pl
                for pl in x.placements])
    return x.reshape(*x.shape[:dim], *sizes, *x.shape[dim + 1:])


class _Flatten(torch.autograd.Function):
    """Dimensions ``dim`` and ``dim + 1`` merged, the gradient split back
    by ``unflatten``."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, dim: int) -> torch.Tensor:
        ctx.dim, ctx.sizes = dim, tuple(x.shape[dim:dim + 2])
        return x.flatten(dim, dim + 1)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return unflatten(grad, ctx.dim, ctx.sizes), None


def flatten(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with dimensions ``dim`` and ``dim + 1`` merged (heads and head
    dimension into one).  Of a DTensor, the gradient is split back by
    ``unflatten``, which first makes the merged dimension whole where
    DTensor cannot split it (fewer heads than the ranks cutting it: the
    gradient of a product with a row-cut weight is cut that way)."""
    dim %= x.ndim
    if isinstance(x, DTensor):
        return _Flatten.apply(x, dim)
    return x.flatten(dim, dim + 1)


@contextlib.contextmanager
def mesh_mode(ctx) -> Iterator[None]:
    """The context a sharded forward and its backward run in: plain
    tensors that meet DTensors (positions, masks, RoPE tables) count as
    replicated (``implicit_replication``, which this nests: the state on
    entry is restored on exit).  Without a context, nothing."""
    if ctx is None:
        yield
        return
    dispatcher = DTensor._op_dispatcher
    before = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = before


# ---------------------------------------------------------------------------
# Shards counted once
# ---------------------------------------------------------------------------
def owns_shard(mesh, pls: Sequence) -> bool:
    """True on the one rank of each group of replicas of a local shard
    laid out by ``pls`` (no ``Partial``): coordinate 0 on every mesh
    dimension where it is replicated.  A sum over ranks of what such ranks
    hold counts each shard once."""
    if any(pl.is_partial() for pl in pls):
        raise ValueError(f"placements {pls}: reduce a partial tensor first")
    return all(c == 0 for c, pl in zip(mesh.get_coordinate(), pls)
               if not pl.is_shard())


def mesh_groups(mesh) -> Iterator:
    """The process group of each mesh dimension: reducing over all of them
    in turn reduces over the whole mesh."""
    return (mesh.get_group(i) for i in range(mesh.ndim))


def weight_grad(spec: Spec, act_spec: Spec, mesh) -> Tuple:
    """Placements of the gradient of a weight laid out by ``spec`` that a
    function on local shards applies to activations laid out by
    ``act_spec``: partial (a sum still to take) over each mesh dimension
    that cuts the activations but not the weight."""
    return tuple(Partial() if a.is_shard() and not w.is_shard() else w
                 for w, a in zip(placements(spec, mesh),
                                 placements(act_spec, mesh)))


def on_shards(fn, mesh, in_specs: Sequence, out_specs,
              grad_placements: Optional[Sequence] = None):
    """``fn`` run on each rank's local shards (``local_map``), as JAX's
    ``shard_map``: each tensor argument is laid out by its spec of
    ``in_specs`` (``None`` for an argument that is not a tensor) and handed
    to ``fn`` as its local shard; ``fn``'s outputs are the local shards of
    DTensors laid out by ``out_specs`` (one spec, or a list of specs for a
    tuple of outputs).  ``grad_placements`` give the placements of the
    inputs' gradients where they differ from the inputs' own (a ``Partial``
    where ``fn`` sees only part of what an input feeds)."""
    def pl(spec):
        return None if spec is None else list(placements(spec, mesh))

    # a list of specs: one per output; one spec: a single output
    outs = ([pl(s) for s in out_specs] if isinstance(out_specs, list)
            else pl(out_specs))
    return on_placements(fn, mesh, [pl(s) for s in in_specs], outs,
                         grad_placements)


def on_placements(fn, mesh, in_pls: Sequence, out_pls,
                  grad_placements: Optional[Sequence] = None):
    """``on_shards`` with DTensor placements, one list per mesh dimension,
    in place of specs (``out_pls``: a list of such lists for a tuple of
    outputs)."""
    from torch.distributed.tensor.experimental import local_map

    # local_map reads a tuple as one placement list per output, a list as
    # the placements of a single output
    multi = bool(out_pls) and isinstance(out_pls[0], (list, tuple))
    outs = (tuple(list(p) for p in out_pls) if multi
            else None if out_pls is None else list(out_pls))
    ins = tuple(None if p is None else list(p) for p in in_pls)
    grads = None if grad_placements is None else tuple(
        None if g is None else tuple(g) for g in grad_placements)

    def lay(a, p):
        if not isinstance(a, torch.Tensor) or p is None:
            return a
        if isinstance(a, DTensor):
            return a.redistribute(mesh, p)
        return distribute_tensor(a, mesh, p, src_data_rank=None)

    def run(*args):
        args = tuple(lay(a, p) for a, p in zip(args, ins))
        return local_map(fn, out_placements=outs, in_placements=ins,
                         in_grad_placements=grads, device_mesh=mesh)(*args)

    return run


# ---------------------------------------------------------------------------
# Tensor-parallel products: the weights gathered over the data axes, the
# products on local shards, one reduction over "model" after a row-cut one
# ---------------------------------------------------------------------------
#: sites run whole on every "model" rank while ``count_whole`` is open
_WHOLE: Optional[Dict[str, int]] = None


@contextlib.contextmanager
def count_whole() -> Iterator[Dict[str, int]]:
    """Count, by site, the products and layers that the sharded program
    runs whole on every "model" rank where the rules would cut them but a
    size does not divide the axis (a weight's rows, a split weight's
    chunks, attention's heads and positions, a recurrent cell's heads): the
    dry-run records them beside its per-device counts."""
    global _WHOLE
    prev, _WHOLE = _WHOLE, {}
    try:
        yield _WHOLE
    finally:
        _WHOLE = prev


def note_whole(site: str) -> None:
    """Record one run of ``site`` whole over "model" (see ``count_whole``)."""
    if _WHOLE is not None:
        _WHOLE[site] = _WHOLE.get(site, 0) + 1


def _tp_dim(ctx) -> int:
    return tuple(ctx.mesh.mesh_dim_names).index(ctx.tp_axis)


def _act_placements(x: torch.Tensor, mesh, t: int, model,
                    site: str = "") -> List:
    """An activation's placements on entry to a product: as it is laid
    out over the data axes (a partial sum taken), ``model`` over "model"
    (``Replicate()`` or ``Shard(last)``; where its size does not divide,
    no cut, and ``site`` is recorded as run whole)."""
    pls = (list(x.placements) if isinstance(x, DTensor)
           else [Replicate()] * mesh.ndim)
    pls = [Replicate() if pl.is_partial() else pl for pl in pls]
    if model.is_shard() and x.shape[-1] % mesh.size(t):
        note_whole(site)
        model = Replicate()
    pls[t] = model if mesh.size(t) > 1 else Replicate()
    return pls


def _weight_placements(name: str, w: torch.Tensor, mesh) -> List:
    """A weight's placements at compute: ``weight_compute_spec``, its
    storage cut over "model" with the FSDP cut gathered (ZeRO-3 style)."""
    return list(placements(weight_compute_spec(name, tuple(w.shape), mesh),
                           mesh))


def _grad_placements(w_pls: Sequence, act_pls: Sequence, t: int) -> Tuple:
    """A weight's gradient from a function on local shards: a partial sum
    over each data axis that cuts the activations."""
    return tuple(Partial() if i != t and a.is_shard() else w
                 for i, (w, a) in enumerate(zip(w_pls, act_pls)))


def columns(ctx, x: torch.Tensor, p: Dict[str, torch.Tensor],
            names: Sequence[str], split: int = 1) -> List[torch.Tensor]:
    """``x @ p[name]`` for each of ``names`` (column-cut weights: their
    output dimension cut over "model"); with ``split``, each product's
    output chunked into ``split`` pieces along its last dimension, as
    ``torch.chunk``.  Without a context, the plain products.

    With one, the products run on local shards: ``x`` whole over "model"
    (through ``comm.copy_to``, which sums the ranks' gradients), each
    weight laid out by ``weight_compute_spec`` (gathered over the data
    axes), each output cut over "model" where its weight is (else whole),
    so that no product runs whole on every "model" rank.  A split weight
    is laid out as (in, split, out / split), cut on its last dimension, so
    that every chunk is cut alike."""
    weights = [p[n] for n in names]
    if ctx is None:
        outs = [x @ w for w in weights]
        return ([c for o in outs for c in torch.chunk(o, split, dim=-1)]
                if split > 1 else outs)
    from repro_torch.parallel import comm
    mesh, t = ctx.mesh, _tp_dim(ctx)
    x_pls = _act_placements(x, mesh, t, Replicate())
    w_pls = [_weight_placements(n, w, mesh) for n, w in zip(names, weights)]
    if split > 1:
        weights = [unflatten(w, -1, (split, w.shape[-1] // split))
                   for w in weights]
        for n, w, pl in zip(names, weights, w_pls):
            if pl[t].is_shard():
                if w.shape[-1] % mesh.size(t):
                    note_whole(n)
                    pl[t] = Replicate()
                else:
                    pl[t] = Shard(w.ndim - 1)
    if any(pl[t].is_shard() and pl[t].dim != w.ndim - 1
           for pl, w in zip(w_pls, weights)):
        raise ValueError("columns: a weight is cut over the mesh other than "
                         "on its output dimension")
    cut = [pl[t].is_shard() for pl in w_pls]
    group = mesh.get_group(ctx.tp_axis)

    def local(xl, *ws):
        xc = comm.copy_to(xl, group, "tp_copy") if any(cut) else xl
        outs = []
        for w, c in zip(ws, cut):
            y = (xc if c else xl) @ (w.reshape(w.shape[0], -1) if split > 1
                                     else w)
            outs.extend(torch.chunk(y, split, dim=-1) if split > 1 else [y])
        return tuple(outs)

    out_pls = []
    for c in cut:
        pl = list(x_pls)
        pl[t] = Shard(x.ndim - 1) if c else Replicate()
        out_pls.extend([pl] * split)
    grads = [x_pls] + [_grad_placements(pl, x_pls, t) for pl in w_pls]
    return list(on_placements(local, mesh, [x_pls] + w_pls, out_pls,
                              grads)(x, *weights))


def rows(ctx, y: torch.Tensor, p: Dict[str, torch.Tensor], name: str,
         scatter: bool = False) -> torch.Tensor:
    """``y @ p[name]`` for a row-cut weight (its input dimension cut over
    "model"); without a context, the plain product.

    With one, the product runs on local shards: ``y`` cut over "model" on
    its last dimension as the weight's rows are, the weight laid out by
    ``weight_compute_spec`` (gathered over the data axes), and the ranks'
    partial sums reduced over "model" at once: an all-reduce
    (``comm.psum``) into an output whole over "model", or with ``scatter``
    a reduce-scatter into one cut on its last dimension (the RG-LRU's
    gates, whose scan runs on lanes cut so)."""
    return rows_sum(ctx, p, [(y, name)], scatter)


def rows_sum(ctx, p: Dict[str, torch.Tensor],
             terms: Sequence[Tuple[torch.Tensor, str]],
             scatter: bool = False) -> torch.Tensor:
    """The sum of ``y @ p[name]`` over ``terms``, each a row-cut product as
    in ``rows``, with one reduction over "model" for all of them (a
    block's output and gated-MLP products, which the residual adds: one
    all-reduce in place of one each).  A term whose activation does not
    divide "model" runs whole and is added after the reduction."""
    if ctx is None:
        out = None
        for y, name in terms:
            o = y @ p[name]
            out = o if out is None else out + o
        return out
    from repro_torch.parallel import comm
    mesh, t = ctx.mesh, _tp_dim(ctx)
    ins, in_pls, grads, cuts = [], [], [], []
    for y, name in terms:
        w = p[name]
        w_pls = _weight_placements(name, w, mesh)
        cut = w_pls[t].is_shard()
        if cut and w_pls[t].dim != 0:
            raise ValueError("rows: a weight is cut over the mesh other than "
                             "on its input dimension")
        y_pls = _act_placements(y, mesh, t, Shard(y.ndim - 1) if cut
                                else Replicate(), name)
        cut = cut and y_pls[t].is_shard()
        if not cut:
            w_pls[t] = Replicate()
        ins += [y, w]
        in_pls += [y_pls, w_pls]
        grads += [y_pls, _grad_placements(w_pls, y_pls, t)]
        cuts.append(cut)
    n_out = p[terms[0][1]].shape[-1]
    if scatter and all(cuts) and n_out % mesh.size(t):
        note_whole(terms[0][1])
    scatter = scatter and all(cuts) and n_out % mesh.size(t) == 0
    group = mesh.get_group(ctx.tp_axis)

    def local(*args):
        part = whole = None
        for i, cut in enumerate(cuts):
            o = args[2 * i] @ args[2 * i + 1]
            if cut:
                part = o if part is None else part + o
            else:
                whole = o if whole is None else whole + o
        if part is not None:
            part = (comm.reduce_scatter(part, group, -1, "tp_reduce_scatter")
                    if scatter else comm.psum(part, group, "tp_reduce"))
        return whole if part is None else (part if whole is None
                                           else part + whole)

    out_pls = list(in_pls[0])
    out_pls[t] = Shard(terms[0][0].ndim - 1) if scatter else Replicate()
    return on_placements(local, mesh, in_pls, out_pls, grads)(*ins)
