# Port of repro/analysis/jaxpr_walk.py.  What differs:
# * A region is traced by torch.fx.experimental.proxy_tensor.make_fx with
#   tracing_mode="fake": the state's leaves go in as tensors on the app's
#   device, in sorted-key order (the order jax flattens a dict in), and the
#   result is an aten graph, the jaxpr's counterpart.  Python loops unroll
#   into it, so the graph has no sub-graphs and the walk needs no rule for
#   scan, while or cond.  No numpy shim: the port's regions keep a tensor
#   state as tensors.
# * Untraced is decided by two rules on the trace, the two ways jax's trace
#   of the same semantics fails:
#   - a host read of state (float, int, .item(), .tolist(), a numpy
#     conversion) raises, as it does on a jax tracer: a fake tensor has no
#     data, so the trace stops with a data-dependent error;
#   - a region writes in place into a tensor derived from state (an
#     in-place aten op, index_put_ among them, whose written operand was
#     made from a state leaf): jax arrays are immutable, and ``x[i] = v`` on
#     a tracer raises.  Writing into a fresh tensor (torch's form of
#     ``.at[i].set(v)``) is not such a write.
# * Discrete tags take the jax primitive's name for the aten op, so the
#   rationales read as jax's: argmin, argmax, sort (sort, argsort, msort),
#   top_k (topk) and the index output of min.dim and max.dim (argmin,
#   argmax); eq, ne, lt, le, gt, ge; select_n (where, masked_fill) with a
#   data-dependent condition; gather (index.Tensor, gather, index_select,
#   take) and scatter / scatter-add (scatter, index_put, index_copy,
#   index_fill, index_add, scatter_add, scatter_reduce, bincount) when their
#   index operand is data-dependent.
# * An in-place op changes every alias of the tensor it writes (the views
#   of one storage), so the walk joins its result into all of them; a jaxpr
#   has no aliases.  ``*_like`` constructors depend on their operand's shape
#   only, as jax's ``full_like`` (a broadcast literal) does.
# * write_bytes equals jax's: a traced leaf of a 64-bit type counts 32 bits,
#   because jax traces with x64 off and the jaxpr's output is int32 or
#   float32 (sor's ``k`` is 4 bytes); an untraced leaf counts its numpy
#   nbytes, as jax's fallback does (heat's ``pin`` writes 4096 + 8).
"""Trace app regions to aten graphs and walk their dataflow.

The walker computes, for every value a region writes, (a) which state
objects it depends on and (b) which ops sit on those input-dependent paths,
with the operand roles that matter for crash classification: comparisons,
``argmin``/``sort``, ``where`` with a data-dependent condition, and
gathers/scatters with data-dependent *indices* are tagged ``discrete:*`` (a
crashed stale input can flip them by a whole category, so no contraction
argument applies); constant-index scatters (boundary pins) and
arange-derived masks are not.

Not every region traces: some call ``int(...)``/``float(...)`` on state
(host-side control flow) or write in place into state.  That is a
*finding*, not an error: :func:`trace_region` returns ``ok=False`` and the
classifier falls back to the region's declared reads/writes at reduced
confidence.
"""
from __future__ import annotations

import operator
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from ..convert import state_to_torch
from ..core.regions import Region, State

#: tag recorded for objects written by a region that could not be traced
UNTRACED = "<untraced>"

# discrete-valued ops, as jax primitive names, by the operand role that
# makes them discrete
_DISCRETE_ALWAYS = {"argmin": "argmin", "argmax": "argmax", "sort": "sort",
                    "argsort": "sort", "msort": "sort", "topk": "top_k"}
_DISCRETE_CMP = frozenset({"eq", "ne", "lt", "le", "gt", "ge"})
#: op -> (position of its condition operand); jax's select_n
_SELECT = {"where": 0, "masked_fill": 1, "masked_fill_": 1}
#: op -> (jax primitive, position of its *index* operand); discrete only
#: when the index is data-dependent (constant-index pins are not)
_INDEX_OPERANDS = {
    "index": ("gather", 1), "_unsafe_index": ("gather", 1),
    "gather": ("gather", 2), "index_select": ("gather", 2), "take": ("gather", 1),
    "index_put": ("scatter", 1), "index_put_": ("scatter", 1),
    "_unsafe_index_put": ("scatter", 1),
    "scatter": ("scatter", 2), "scatter_": ("scatter", 2),
    "index_copy": ("scatter", 2), "index_copy_": ("scatter", 2),
    "index_fill": ("scatter", 2), "index_fill_": ("scatter", 2),
    "index_add": ("scatter-add", 2), "index_add_": ("scatter-add", 2),
    "scatter_add": ("scatter-add", 2), "scatter_add_": ("scatter-add", 2),
    "scatter_reduce": ("scatter-add", 2), "scatter_reduce_": ("scatter-add", 2),
    "bincount": ("scatter-add", 0),
}
#: (min|max).dim return (values, indices); the indices are an arg-reduction
_ARG_OUTPUT = {"min": "argmin", "max": "argmax"}
#: the types jax's x64-off trace narrows to 32 bits
_X64 = frozenset({torch.int64, torch.float64, torch.complex128})
#: constructors that read only their operand's shape and dtype
SHAPE_ONLY = frozenset({"zeros_like", "ones_like", "empty_like", "full_like",
                        "new_zeros", "new_ones", "new_empty", "new_full"})


# ------------------------------------------------------------- graph helpers
def op_name(node) -> str:
    """The aten op's name without namespace or overload (``"add"``,
    ``"index_put_"``); ``"getitem"`` for a tuple projection."""
    if node.target is operator.getitem:
        return "getitem"
    schema = getattr(node.target, "_schema", None)
    if schema is not None:
        return schema.name.split("::")[-1]
    return getattr(node.target, "__name__", str(node.target))


def _schema(node):
    return getattr(node.target, "_schema", None)


def mutated_args(node) -> List[object]:
    """The graph nodes an in-place op writes (its ``Tensor(a!)`` operands)."""
    schema = _schema(node)
    if schema is None:
        return []
    out = []
    for i, arg in enumerate(schema.arguments):
        if arg.alias_info is None or not arg.alias_info.is_write:
            continue
        val = node.args[i] if i < len(node.args) else node.kwargs.get(arg.name)
        if isinstance(val, torch.fx.Node):
            out.append(val)
    return out


def view_source(node) -> Optional[object]:
    """The node whose storage ``node`` aliases, for a view op (and for a
    projection of a view op's tuple output); else None."""
    if node.target is operator.getitem:
        src = node.args[0]
        return src if isinstance(src, torch.fx.Node) and view_source(src) is not None else None
    schema = _schema(node)
    if schema is None or not schema.returns:
        return None
    ret = schema.returns[0].alias_info
    if ret is None or ret.is_write:
        return None
    for i, arg in enumerate(schema.arguments):
        if arg.alias_info is not None and not arg.alias_info.is_write:
            val = node.args[i] if i < len(node.args) else node.kwargs.get(arg.name)
            if isinstance(val, torch.fx.Node):
                return val
    return None


class AliasGroups:
    """Which graph nodes share a storage: a view joins its source's group."""

    def __init__(self):
        self._root: Dict[object, object] = {}
        self._members: Dict[object, List[object]] = {}

    def add(self, node, source=None) -> None:
        """Register ``node`` (in graph order), in ``source``'s group if it
        is a view of it."""
        root = node if source is None else self._root[source]
        self._root[node] = root
        self._members.setdefault(root, []).append(node)

    def members(self, node) -> List[object]:
        root = self._root.get(node, node)
        return self._members.get(root, [node])


def arg_nodes(value) -> List[object]:
    """Every graph node in a (possibly nested) argument value, in order."""
    out: List[object] = []

    def visit(v):
        if isinstance(v, torch.fx.Node):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            for x in v:
                visit(x)
        elif isinstance(v, dict):
            for x in v.values():
                visit(x)

    visit(value)
    return out


def graph_inputs(graph) -> List[object]:
    return [n for n in graph.nodes if n.op == "placeholder"]


def graph_outputs(graph) -> List[object]:
    for n in graph.nodes:
        if n.op == "output":
            outs = n.args[0]
            return list(outs) if isinstance(outs, (list, tuple)) else [outs]
    return []


def node_val(node):
    """The tensor (fake or real) a node computed during the trace, if any."""
    return node.meta.get("val") if isinstance(node, torch.fx.Node) else None


# --------------------------------------------------------------- dataflow
@dataclass(frozen=True)
class RegionTrace:
    """Dataflow summary of one region (or the declared-metadata fallback)."""

    name: str
    ok: bool
    #: written object -> state objects its new value depends on
    deps: Mapping[str, FrozenSet[str]]
    #: written object -> ops on its input-dependent paths
    #: (plus ``discrete:*`` tags and :data:`UNTRACED`)
    ops: Mapping[str, FrozenSet[str]]
    #: statically estimated bytes this region writes per iteration
    write_bytes: int
    error: str = ""

    def reads(self) -> FrozenSet[str]:
        """State objects whose current value this region consumes."""
        out: FrozenSet[str] = frozenset()
        for d in self.deps.values():
            out |= d
        return out


Info = Tuple[FrozenSet[str], FrozenSet[str]]  # (deps, ops)
_EMPTY: Info = (frozenset(), frozenset())


def _union(infos: Sequence[Info]) -> Info:
    deps = frozenset().union(*(d for d, _ in infos)) if infos else frozenset()
    ops = frozenset().union(*(o for _, o in infos)) if infos else frozenset()
    return deps, ops


def _discrete_tags(name: str, arg_info) -> FrozenSet[str]:
    """``discrete:*`` tags an op contributes, given each argument's info
    (``arg_info(i)`` is the union over the nodes of argument ``i``)."""
    if name in _DISCRETE_ALWAYS:
        return frozenset({f"discrete:{_DISCRETE_ALWAYS[name]}"})
    if name in _DISCRETE_CMP:
        return frozenset({f"discrete:{name}"})
    if name in _SELECT and arg_info(_SELECT[name])[0]:
        # data-dependent condition: the selection itself can flip
        return frozenset({"discrete:select_n"})
    if name in _INDEX_OPERANDS:
        prim, pos = _INDEX_OPERANDS[name]
        if arg_info(pos)[0]:
            return frozenset({f"discrete:{prim}"})
    return frozenset()


def walk_graph(graph, in_info: Sequence[Info]) -> List[Info]:
    """Propagate (deps, ops) from an aten graph's inputs to its outputs."""
    env: Dict[object, object] = {}
    aliases = AliasGroups()
    for node, info in zip(graph_inputs(graph), in_info):
        env[node] = info
        aliases.add(node)

    def read(v) -> Info:
        info = env.get(v, _EMPTY) if isinstance(v, torch.fx.Node) else _EMPTY
        return _union(list(info)) if isinstance(info, list) else info

    for node in graph.nodes:
        if node.op in ("placeholder", "output"):
            continue
        if node.op != "call_function":
            env[node] = _EMPTY
            aliases.add(node)
            continue
        aliases.add(node, view_source(node))
        name = op_name(node)
        if name == "getitem":
            src, idx = node.args
            val = env.get(src, _EMPTY)
            env[node] = val[idx] if isinstance(val, list) else val
            continue
        if name in SHAPE_ONLY:
            env[node] = _EMPTY
            continue
        infos = [read(v) for v in arg_nodes((node.args, node.kwargs))]
        deps, ops = _union(infos)
        n_out = len(node_val(node)) if isinstance(node_val(node), (list, tuple)) else 0
        if not deps:
            env[node] = [_EMPTY] * n_out if n_out else _EMPTY
            continue

        def arg_info(i):
            v = node.args[i] if i < len(node.args) else None
            return _union([read(x) for x in arg_nodes(v)])

        ops = ops | {name} | _discrete_tags(name, arg_info)
        if n_out:
            outs = [(deps, ops)] * n_out
            if name in _ARG_OUTPUT and n_out == 2:
                outs[1] = (deps, ops | {f"discrete:{_ARG_OUTPUT[name]}"})
            env[node] = outs
        else:
            env[node] = (deps, ops)
        # an in-place write changes every view of the written storage
        for target in mutated_args(node):
            for member in aliases.members(target):
                env[member] = _union([read(member), (deps, ops)])
    return [read(v) for v in graph_outputs(graph)]


def inplace_state_writes(graph) -> List[str]:
    """In-place ops of ``graph`` whose written operand was made from a
    graph input: what a jax trace refuses (its arrays are immutable).

    Derivation follows how a tensor was *made* (ops and views of inputs);
    writing into a fresh tensor does not make it state."""
    derived: Dict[object, bool] = {}
    found = []
    for node in graph.nodes:
        if node.op != "call_function":
            derived[node] = node.op == "placeholder"
            continue
        name = op_name(node)
        written = mutated_args(node)
        found += [f"aten.{name}" for t in written if derived.get(t, False)]
        if name in SHAPE_ONLY:
            srcs = []
        elif written:
            # an in-place op returns its written operand, made as it was
            srcs = written[:1]
        elif name == "getitem" or view_source(node) is not None:
            srcs = arg_nodes(node.args[0])
        else:
            srcs = arg_nodes((node.args, node.kwargs))
        derived[node] = any(derived.get(v, False) for v in srcs)
    return found


def traced_nbytes(val) -> int:
    """Bytes of a traced output as jax's x64-off trace types it: 64-bit
    integers and floats are 32-bit there (complex128 is complex64)."""
    itemsize = val.element_size()
    if val.dtype in _X64:
        itemsize //= 2
    return int(val.numel()) * itemsize


def trace_region(state: State, region: Region,
                 const_objects: FrozenSet[str] = frozenset(),
                 device: str = "cpu") -> RegionTrace:
    """Trace one region against an example state; falls back to declared
    metadata (``reads + writes``, self-dependent, :data:`UNTRACED`) when the
    region body cannot be traced.

    ``const_objects`` names state entries no region ever writes: they are
    rebuilt bit-identically by ``restart_init`` after a crash, so for crash
    dataflow they are constants — a scatter whose indices come from a
    read-only pin table is *not* data-dependent."""
    keys = sorted(state)
    written = [w for w in sorted(region.writes)]

    def fn(*leaves):
        out = region.fn(dict(zip(keys, leaves)))
        return tuple(out[k] for k in written if k in out)

    def fallback(error: str) -> RegionTrace:
        deps = {w: (frozenset(region.reads) | {w}) - const_objects
                for w in region.writes}
        ops = {w: frozenset({UNTRACED}) for w in region.writes}
        wb = sum(int(np.asarray(state[w]).nbytes) for w in region.writes if w in state)
        return RegionTrace(region.name, False, deps, ops, wb, error=error)

    tensors = state_to_torch(state, device)
    leaves = [tensors[k] for k in keys]
    try:
        gm = make_fx(fn, tracing_mode="fake")(*leaves)
    except Exception as e:  # noqa: BLE001 - untraceable is a finding, not an error
        return fallback(f"{type(e).__name__}: {e}")
    writes = inplace_state_writes(gm.graph)
    if writes:
        return fallback(f"InPlaceStateWrite: {', '.join(sorted(set(writes)))} writes in "
                        "place into a tensor made from state (jax arrays are immutable)")

    # the inputs go in sorted-key order, one leaf per state entry
    in_info: List[Info] = [
        (_EMPTY[0] if k in const_objects else frozenset({k}), frozenset())
        for k in keys
    ]
    out_info = walk_graph(gm.graph, in_info)
    outs = graph_outputs(gm.graph)
    deps = {}
    ops = {}
    wb = 0
    for w, (d, o), node in zip(written, out_info, outs):
        deps[w] = d
        ops[w] = o
        val = node_val(node)
        if isinstance(val, torch.Tensor):
            wb += traced_nbytes(val)
        elif w in state:
            wb += int(np.asarray(state[w]).nbytes)
    return RegionTrace(region.name, True, deps, ops, int(wb))
