"""Per-device cost of a step, counted while it runs: FLOPs, bytes,
collective bytes and peak memory, ported from ``repro.launch.costing``.

The reference reads its counts from a compiled XLA program
(``cost_analysis``, ``memory_analysis`` and the post-SPMD HLO text).  The
port has no compiled program: it counts the operators a step dispatches,
once each, under a ``TorchDispatchMode`` (:class:`Counter`).  Run on fake
tensors (``FakeTensorMode``, ``launch.shapes``) the step allocates and
computes nothing, so a step of a 512-rank mesh is traced by one process on
a fake process group; run on the card it counts the same operators, since
what it counts depends on shapes alone.

* **FLOPs**: ``torch.utils.flop_counter``'s formulas, the ones
  ``FlopCounterMode`` applies (matrix products, attention, convolutions;
  elementwise operators count none), with the kernel operators' own
  (``kernels.ops``, from ``kernels.work``).
* **Bytes**: each operator's tensor inputs and outputs, each once.  A view
  or alias, a wait, an uninitialised allocation and a query that returns
  no tensor (a device, a size) move nothing and count 0; a kernel operator
  counts its formula's bytes.
* **Collectives**: by kind, with the reference's table of operand bytes and
  ring-link bytes (:func:`collective_cost`), from the functional
  collectives that DTensor issues (``_c10d_functional``, its
  ``_dtensor`` all-to-all) and the ``c10d`` operators that the port's ``parallel/comm.py`` and pipeline
  call, each with its group's size.
* **Memory**: the peak of the bytes the step allocated and still holds
  (each storage counted from the operator that made it until it is freed),
  beside the argument bytes (the local shards of parameters, optimizer
  state, batch and caches) that the caller adds.

**Every count is per device**, as the reference's post-SPMD counts are.
An operator on DTensors is not counted at its global shapes: the counter
lets DTensor run it (``NotImplemented``) and counts the local operators
and collectives it becomes, on this rank's shards.  DTensor's own shape
propagation, which runs the operator on global fake tensors to learn the
output's shape, is not counted.

**The reference's trip-count correction has no counterpart here.** XLA
counts a ``while`` body once, so the reference unrolls its inner loops in
a cost mode (``repro.models.scan_utils``: ``cost_mode``, ``maybe_scan``)
and multiplies bodies by their trip counts.  The port's loops are Python
loops, and every count sees every iteration, so a whole-step count is
exact.  What remains of the correction is time: a cell whose trace takes
millions of operators (the sLSTM's loop over 32k steps) is traced at two
shorter lengths and fitted (``launch.dryrun``), the port's counterpart of
``scan_utils``.
"""

from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import ops

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

#: the kind of each collective operator: functional (DTensor) and c10d
#: (``dist.*`` calls); point-to-point sends and the pipeline's broadcast
#: move one tensor across ranks, as XLA's collective-permute does
_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "allreduce_": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "_allgather_base_": "all-gather",
    "allgather_": "all-gather", "allgather_into_tensor_coalesced_":
    "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast_": "collective-permute", "broadcast": "collective-permute",
}
_NAMESPACES = ("_c10d_functional", "c10d", "_dtensor")
#: views that the schema does not mark as views: they share their input's
#: storage
_VIEWS = {"_unsafe_view"}
#: operators that move no bytes: views, waits, and allocations that write
#: nothing
_NO_BYTES = _VIEWS | {"wait_tensor", "empty", "empty_strided", "empty_like",
                      "new_empty", "new_empty_strided"}


def collective_cost(kind: str, result_bytes: float,
                    group: int) -> Tuple[float, float]:
    """(operand bytes, ring-link bytes) of one collective whose result has
    ``result_bytes`` over a group of ``group`` ranks, as the reference's
    ``collective_bytes`` reads an HLO instruction:
        all-reduce         op=R      link=2·R·(G-1)/G
        all-gather         op=R/G    link=R·(G-1)/G
        reduce-scatter     op=R·G    link=R·(G-1)
        all-to-all         op=R      link=R·(G-1)/G
        collective-permute op=R      link=R
    """
    R, G = float(result_bytes), max(int(group), 1)
    if kind == "all-reduce":
        return R, 2.0 * R * (G - 1) / G
    if kind == "all-gather":
        return R / G, R * (G - 1) / G
    if kind == "reduce-scatter":
        return R * G, R * (G - 1)
    if kind == "all-to-all":
        return R, R * (G - 1) / G
    if kind == "collective-permute":
        return R, R
    raise ValueError(kind)


def empty_coll() -> Dict[str, float]:
    out: Dict[str, float] = {}
    for k in COLLECTIVES:
        out[k] = out[k + "_link"] = out[k + "_count"] = 0.0
    out["total"] = out["total_link"] = 0.0
    return out


@dataclass
class Cost:
    """The reference's cost record: FLOPs, bytes and ``collective_cost``'s
    keys (operand and link bytes and counts by kind, and totals)."""
    flops: float = 0.0
    bytes_accessed: float = 0.0
    coll: Dict[str, float] = field(default_factory=dict)


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _group(args) -> Tuple[int, str]:
    """The size and name of the group a collective runs over: its
    ``ProcessGroup``'s, else those of the group its ``group_name`` names,
    else its ``group_size`` argument and no name."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                pg = dist.ProcessGroup.unbox(a)
            except (RuntimeError, TypeError):
                continue          # a ReduceOp
            return pg.size(), pg.group_name
    ints = [a for a in args if isinstance(a, int) and not isinstance(a, bool)]
    names = [a for a in args if isinstance(a, str)]
    if names:
        return _resolve_process_group(names[-1]).size(), names[-1]
    return (ints[-1] if ints else 1), ""


def mesh_axes(mesh) -> Dict[str, str]:
    """The name of each mesh dimension's process group -> the dimension's
    name, for ``Counter(axes=...)``."""
    if mesh is None:
        return {}
    return {mesh.get_group(i).group_name: name
            for i, name in enumerate(mesh.mesh_dim_names)}


@contextlib.contextmanager
def patched(obj, name: str, value) -> Iterator[None]:
    """``obj.name`` set to ``value`` inside, restored on the way out."""
    original = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, original)


def _uncounted_propagation(counter: "Counter"):
    """DTensor learns an operator's output shape by running it on fake
    tensors of the global shapes; those calls are not the step's work."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    name = "_propagate_tensor_meta_non_cached"
    original = getattr(ShardingPropagator, name)

    def propagate(self, *args, **kwargs):
        counter.paused += 1
        try:
            return original(self, *args, **kwargs)
        finally:
            counter.paused -= 1

    return patched(ShardingPropagator, name, propagate)


class Counter(TorchDispatchMode):
    """Counts the operators dispatched inside it (see the module's
    docstring): ``flops``, ``bytes``, ``flops_by_op`` (operator name ->
    FLOPs), ``kernels`` (kernel operator name -> calls), ``coll`` (the
    reference's collective keys, and with ``axes`` the operand and link
    bytes and counts by the mesh dimension each collective's group spans:
    ``total@<axis>``, ``total_link@<axis>``, ``count@<axis>``, "other" for
    a group of no single dimension), and the step's memory, ``peak_bytes``
    and ``live_bytes`` (allocated inside and held at the peak, and at the
    end).  ``axes`` maps a group's name to its mesh dimension's
    (``mesh_axes``)."""

    def __init__(self, axes: Optional[Dict[str, str]] = None) -> None:
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.flops_by_op: Dict[str, float] = {}
        self.kernels: Dict[str, int] = {}
        self.axes = dict(axes or {})
        self.coll = empty_coll()
        if self.axes:
            for axis in list(self.axes.values()) + ["other"]:
                for key in ("total", "total_link", "count"):
                    self.coll[f"{key}@{axis}"] = 0.0
        self.live_bytes = 0
        self.peak_bytes = 0
        self.paused = 0
        self._held: Dict[int, int] = {}
        self._stack = contextlib.ExitStack()

    def __enter__(self):
        self._stack.enter_context(_uncounted_propagation(self))
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._stack.close()

    def cost(self) -> Cost:
        return Cost(self.flops, self.bytes, dict(self.coll))

    # -------------------------------------------------------------- memory
    def _release(self, key: int) -> None:
        self.live_bytes -= self._held.pop(key, 0)

    def _hold(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        key = storage._cdata
        if key in self._held:
            return
        n = storage.nbytes()
        self._held[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(storage, self._release, key)

    # ------------------------------------------------------------ dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # count the local operators instead
        out = func(*args, **kwargs)
        if self.paused:
            return out
        name = func._overloadpacket.__name__
        if func in ops.KERNEL_OPS:
            w = ops.op_work(func, args)
            self.flops += w.flops
            self.bytes += w.bytes
            self.kernels[name] = self.kernels.get(name, 0) + 1
            self.flops_by_op[name] = self.flops_by_op.get(name, 0) + w.flops
        else:
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None:
                f = float(formula(*args, **kwargs, out_val=out))
                self.flops += f
                self.flops_by_op[name] = self.flops_by_op.get(name, 0) + f
            if not (func.is_view or name in _NO_BYTES or not _tensors(out)):
                self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        if func.namespace in _NAMESPACES and name in _KINDS:
            self._collective(_KINDS[name], func, args, out)
        self._allocated(func, out)
        return out

    def _collective(self, kind: str, func, args, out) -> None:
        # the result: the output of a functional collective; the first
        # argument (the tensors, or the output) of a c10d one
        result = args[0] if func.namespace == "c10d" else out
        size, name = _group(args)
        op, link = collective_cost(kind, _nbytes(result), size)
        self.coll[kind] += op
        self.coll[kind + "_link"] += link
        self.coll[kind + "_count"] += 1
        self.coll["total"] += op
        self.coll["total_link"] += link
        if self.axes:
            axis = self.axes.get(name, "other")
            self.coll[f"total@{axis}"] += op
            self.coll[f"total_link@{axis}"] += link
            self.coll[f"count@{axis}"] += 1

    def _allocated(self, func, out) -> None:
        """Hold the storage of each output that the operator made (not a
        view, not written in place)."""
        if func._overloadpacket.__name__ in _VIEWS:
            return
        returns = func._schema.returns
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for ret, o in zip(returns, outs):
            if ret.alias_info is None and isinstance(o, torch.Tensor):
                self._hold(o)


def count(fn, *args, axes: Optional[Dict[str, str]] = None,
          **kwargs) -> Tuple[Any, Counter]:
    """``fn(*args, **kwargs)`` run under a :class:`Counter` (``axes`` as
    its); returns its output and the counter."""
    counter = Counter(axes)
    with counter:
        out = fn(*args, **kwargs)
    return out, counter


def local_bytes(tree) -> int:
    """Bytes this rank holds of ``tree``'s tensors: a DTensor's local
    shard, a plain tensor whole."""
    return sum(t.to_local().numel() * t.element_size()
               if isinstance(t, DTensor) else t.numel() * t.element_size()
               for t in _tensors(tree))


def memory(counter: Counter, argument_bytes: float) -> Dict[str, float]:
    """The reference's ``memory_of_compiled`` keys: the argument bytes, the
    step's allocations held at its end (output) and at its peak (temp),
    and their total at the peak."""
    out = {"argument_size_in_bytes": float(argument_bytes),
           "output_size_in_bytes": float(counter.live_bytes),
           "temp_size_in_bytes": float(counter.peak_bytes),
           "generated_code_size_in_bytes": 0.0,
           "alias_size_in_bytes": 0.0}
    out["total_hbm_bytes"] = (out["argument_size_in_bytes"]
                              + out["temp_size_in_bytes"])
    return out
