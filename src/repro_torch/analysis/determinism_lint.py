# Port of repro/analysis/determinism_lint.py.  What differs:
# * A kernel is traced by make_fx with tracing_mode="real", on its example
#   arguments (montecarlo's tally is a bincount, whose output size depends
#   on the data, which a fake trace refuses), and the walk propagates the
#   lane axis over the aten graph.
# * aten broadcasts implicitly, so a pointwise op (torch.Tag.pointwise)
#   aligns each operand's lane axis from the right, where a jaxpr has an
#   explicit broadcast_in_dim; views and shape ops (view, reshape, expand,
#   permute, transpose, unsqueeze, squeeze, slice, select, unbind, pad, cat,
#   stack, flip) keep or move the lane axis, or are findings where they
#   fold it into another dimension.
# * A Python loop over lanes is the torch form of lax.map: it unrolls into
#   one select (or unbind) per lane, so a value may belong to a single lane
#   i, on which any op (a matmul included) is the serial program; stacking
#   the per-lane results 0..L-1 in order gives a laned value again.  Mixing
#   two lanes' values, or one lane's with the laned stack, is a finding.
# * An in-place op writes its lane layout into the tensor it mutates and
#   every view of it.
# * The products flagged are mm, bmm, mv, addmm, addmv, addbmm, baddbmm,
#   matmul, dot, vdot, einsum, linear, tensordot, outer, convolution and
#   _scaled_mm with a laned operand, where jax flags dot_general.
"""Bitwise-batchability lint for batched step kernels.

The vectorized campaign engine requires every ``supports_batched_step`` app
to advance stacked restart lanes *bitwise identically* to the serial hooks
(``core/regions.py`` contract).  The classic violation is a vmapped matmul:
``vmap(lambda u: A @ u)`` batches the contraction into a matrix-matrix
product with a different reduction tiling, so lane i's result is no longer
the serial matvec bit for bit.

The lint walks a batched kernel's aten graph propagating, per intermediate
value, *which axis carries the lane dimension* (or none, or one lane's
value).  An operation is safe when each lane's slice of its output is
computed by exactly the program the serial kernel would run:

* pointwise and shape-only ops preserve the lane axis;
* reductions over non-lane axes are per-lane;
* a Python loop over lanes (select or unbind per lane, then stack) runs the
  serial program once per lane: the sanctioned way to batch a matmul.

Everything else touching a laned value is a finding, with the products
called out specially: **any** contraction with a lane-carrying operand is
flagged, because batched GEMM tilings are not guaranteed bitwise-per-lane —
the default-deny that makes the lint an allowlist, not a blocklist.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple, Union

import torch
from torch.fx.experimental.proxy_tensor import make_fx

from .fx_walk import (SHAPE_ONLY, AliasGroups, arg_nodes, graph_inputs, mutated_args,
                      node_val, op_name, view_source)

#: a value's lane layout: None (lane-free), an int (the axis carrying the
#: lanes) or ("one", i) (lane i's value alone)
Lane = Union[None, int, Tuple[str, int]]

#: elementwise ops torch does not tag pointwise (copy_ writes its source's
#: elements into its target's)
_COPY_LIKE = frozenset({"_to_copy", "clone", "alias", "detach", "lift_fresh_copy", "copy",
                        "copy_"})
_PRODUCTS = frozenset({"mm", "bmm", "mv", "addmm", "addmv", "addbmm", "baddbmm", "matmul",
                       "dot", "vdot", "einsum", "linear", "tensordot", "outer", "ger",
                       "convolution", "_convolution", "_scaled_mm"})
#: reductions: op -> (position of the dims argument, of keepdim)
_REDUCTIONS = {
    "sum": (1, 2), "mean": (1, 2), "prod": (1, 2), "amax": (1, 2), "amin": (1, 2),
    "argmax": (1, 2), "argmin": (1, 2), "max": (1, 2), "min": (1, 2), "any": (1, 2),
    "all": (1, 2), "logsumexp": (1, 2), "nansum": (1, 2), "linalg_vector_norm": (2, 3),
    "norm": (2, 3), "var": (1, 3), "std": (1, 3), "var_mean": (1, 3), "std_mean": (1, 3),
    "count_nonzero": (1, None), "aminmax": (1, 2),
}
_CUMULATIVE = frozenset({"cumsum", "cumprod", "cummax", "cummin", "logcumsumexp"})
_SORTS = frozenset({"sort", "argsort", "topk", "msort"})


@dataclass(frozen=True)
class LintFinding:
    kernel: str
    primitive: str
    reason: str

    def __str__(self) -> str:
        return f"{self.kernel}: {self.primitive}: {self.reason}"


def _ndim(node) -> int:
    val = node_val(node)
    return val.dim() if isinstance(val, torch.Tensor) else 0


def _shape(node) -> Tuple[int, ...]:
    val = node_val(node)
    return tuple(int(s) for s in val.shape) if isinstance(val, torch.Tensor) else ()


def _one(lane: Lane) -> bool:
    return isinstance(lane, tuple)


class _Walker:
    def __init__(self, kernel: str):
        self.kernel = kernel
        self.findings: List[LintFinding] = []

    def flag(self, prim: str, reason: str) -> None:
        self.findings.append(LintFinding(self.kernel, prim, reason))

    # ---------------------------------------------------------------- walk
    def walk(self, graph, in_lanes: Sequence[Lane]) -> None:
        env: Dict[object, object] = {}
        aliases = AliasGroups()
        for node, lane in zip(graph_inputs(graph), in_lanes):
            env[node] = lane
            aliases.add(node)
        for node in graph.nodes:
            if node.op in ("placeholder", "output"):
                continue
            if node.op != "call_function":
                env[node] = None
                aliases.add(node)
                continue
            aliases.add(node, view_source(node))
            if op_name(node) == "getitem":
                src, idx = node.args
                val = env.get(src)
                env[node] = val[idx] if isinstance(val, list) else val
                continue
            out = self._node(node, env)
            env[node] = out
            for target in mutated_args(node):
                self._write_through(node, target, out, env, aliases)

    def _write_through(self, node, target, lane: Lane, env, aliases) -> None:
        """An in-place op's result layout lands in every view of its target."""
        members = aliases.members(target)
        if isinstance(lane, int) and any(_shape(m) != _shape(node) for m in members):
            self.flag(op_name(node), "in-place write of laned data through a view")
            lane = None
        for m in members:
            env[m] = lane

    # ----------------------------------------------------------- one node
    def _node(self, node, env) -> object:
        prim = op_name(node)
        ins = [(v, env.get(v)) for v in arg_nodes((node.args, node.kwargs))]
        laned = [(v, lane) for v, lane in ins if lane is not None]
        n_out = len(node_val(node)) if isinstance(node_val(node), (list, tuple)) else 0

        def out(lane):
            if isinstance(lane, list):
                return lane
            return [lane] * n_out if n_out else lane

        if not laned or prim in SHAPE_ONLY:
            return out(None)
        ones = {lane for _, lane in laned if _one(lane)}
        axes = [(v, lane) for v, lane in laned if isinstance(lane, int)]
        if ones and not axes:
            if len(ones) == 1:
                # one lane's serial program: any op is safe on it
                return out(next(iter(ones)))
            if prim in ("stack", "cat"):
                return self._stack_lanes(node, prim, env)
            self.flag(prim, f"mixes lanes {sorted(i for _, i in ones)}")
            return out(None)
        if ones:
            self.flag(prim, "mixes one lane's value with the laned stack")
            return out(None)

        lane = axes[0][1]
        if prim in _PRODUCTS:
            # default-deny: batched GEMM reduction tilings are not
            # guaranteed bitwise-per-lane, whatever role the lane dim plays
            self.flag(prim, "contraction with a lane-carrying operand is not "
                            "bitwise-per-lane; batch matmuls with a loop over lanes")
            return out(None)
        if torch.Tag.pointwise in getattr(node.target, "tags", ()) or prim in _COPY_LIKE:
            return out(self._pointwise(node, prim, axes))
        if prim in _REDUCTIONS:
            return out(self._reduce(node, prim, lane))
        if prim in _CUMULATIVE or prim in _SORTS:
            pos = 2 if prim == "topk" else 1
            dim = 0 if prim == "msort" else (
                node.args[pos] if len(node.args) > pos else node.kwargs.get("dim", -1))
            if dim % _ndim(node.args[0]) == lane:
                self.flag(prim, f"{prim} along the lane axis {lane}")
                return out(None)
            return out(lane)
        return out(self._shape_op(node, prim, lane, axes))

    def _pointwise(self, node, prim: str, axes) -> Lane:
        val = node_val(node)
        shape = tuple((val[0] if isinstance(val, (list, tuple)) else val).shape)
        outs = set()
        for v, lane in axes:
            o = lane + len(shape) - _ndim(v)
            if _shape(v)[lane] != shape[o]:
                self.flag(prim, f"broadcasts the lane axis {lane} (adds phantom lanes)")
                return None
            outs.add(o)
        if len(outs) > 1:
            self.flag(prim, f"operands disagree on lane axis {sorted(outs)}")
            return None
        return outs.pop()

    def _reduce(self, node, prim: str, lane: int) -> Lane:
        dims_pos, keep_pos = _REDUCTIONS[prim]
        nd = _ndim(node.args[0])
        dims = node.args[dims_pos] if len(node.args) > dims_pos else node.kwargs.get("dim")
        keep = False
        if keep_pos is not None:
            keep = node.args[keep_pos] if len(node.args) > keep_pos \
                else node.kwargs.get("keepdim", False)
        if dims is None or (isinstance(dims, (list, tuple)) and len(dims) == 0):
            dims = list(range(nd))
        if isinstance(dims, int):
            dims = [dims]
        dims = [int(d) % nd for d in dims] if nd else []
        if lane in dims:
            self.flag(prim, f"reduces over the lane axis {lane} (cross-lane reduction)")
            return None
        return lane if keep else lane - sum(1 for d in dims if d < lane)

    def _stack_lanes(self, node, prim: str, env) -> Lane:
        """``stack``/``cat`` of per-lane values: lanes 0..L-1 in order along
        one dimension make that dimension the lane axis."""
        items = node.args[0]
        dim = node.args[1] if len(node.args) > 1 else node.kwargs.get("dim", 0)
        lanes = [env.get(v) for v in items]
        ok = all(_one(x) for x in lanes) and [x[1] for x in lanes] == list(range(len(lanes)))
        if prim == "cat":
            ok = ok and all(_shape(v)[dim % _ndim(v)] == 1 for v in items)
        if not ok:
            self.flag(prim, "stacks values of several lanes out of lane order")
            return None
        return dim % _ndim(node)

    def _shape_op(self, node, prim: str, lane: int, axes) -> Lane:
        src = node.args[0]
        in_shape, out_shape = _shape(src), _shape(node)
        nd_in = len(in_shape)
        if prim in ("view", "_unsafe_view", "reshape", "view_copy", "_reshape_alias"):
            # a row-major reshape keeps lane i's elements at lane index i
            # when the dimensions before the lane axis keep their product
            before = math.prod(in_shape[:lane])
            for o in range(len(out_shape)):
                if math.prod(out_shape[:o]) == before and out_shape[o] == in_shape[lane]:
                    return o
            self.flag(prim, f"reshape {in_shape} -> {out_shape} mixes the "
                            f"lane axis into other dimensions")
            return None
        if prim in ("expand", "expand_copy"):
            o = lane + len(out_shape) - nd_in
            if in_shape[lane] != out_shape[o]:
                self.flag(prim, "broadcasts the lane axis (adds phantom lanes)")
                return None
            return o
        if prim in ("permute", "permute_copy"):
            perm = [int(p) % nd_in for p in node.args[1]]
            return perm.index(lane)
        if prim in ("t", "transpose", "swapaxes"):
            d0, d1 = (0, 1) if prim == "t" else (int(node.args[1]) % nd_in,
                                                 int(node.args[2]) % nd_in)
            return d1 if lane == d0 else d0 if lane == d1 else lane
        if prim == "unsqueeze":
            d = int(node.args[1]) % len(out_shape)
            return lane + (1 if d <= lane else 0)
        if prim == "squeeze":
            if len(node.args) > 1:
                dims = node.args[1] if isinstance(node.args[1], (list, tuple)) else [node.args[1]]
                dims = [int(d) % nd_in for d in dims if in_shape[int(d) % nd_in] == 1]
            else:
                dims = [d for d, s in enumerate(in_shape) if s == 1]
            if lane in dims:
                self.flag(prim, "squeezes away the lane axis")
                return None
            return lane - sum(1 for d in dims if d < lane)
        if prim in ("slice", "flip", "roll", "narrow"):
            # a static slice or reversal: each output lane is one input
            # lane's data
            return lane
        if prim == "select":
            d, i = int(node.args[1]) % nd_in, int(node.args[2])
            if d == lane:
                return ("one", i % in_shape[lane])
            return lane - (1 if d < lane else 0)
        if prim == "unbind":
            d = int(node.args[1]) % nd_in if len(node.args) > 1 else 0
            n = in_shape[d]
            if d == lane:
                return [("one", i) for i in range(n)]
            return [lane - (1 if d < lane else 0)] * n
        if prim in ("split", "split_with_sizes", "chunk", "tensor_split"):
            d = int(node.args[2]) % nd_in if len(node.args) > 2 else 0
            if d == lane:
                self.flag(prim, "splits along the lane axis")
                return [None] * len(node_val(node))
            return [lane] * len(node_val(node))
        if prim == "constant_pad_nd":
            pad = list(node.args[1])
            for i in range(0, len(pad), 2):
                d = nd_in - 1 - i // 2
                if d == lane and (pad[i] or pad[i + 1]):
                    self.flag(prim, "pads along the lane axis (adds phantom lanes)")
                    return None
            return lane
        if prim in ("cat", "stack"):
            if any(x != lane for _, x in axes):
                self.flag(prim, "operands disagree on lane axis")
                return None
            if prim == "stack":
                d = int(node.args[1]) % len(out_shape) if len(node.args) > 1 else 0
                return lane + (1 if d <= lane else 0)
            return lane
        self.flag(prim, f"op not on the bitwise-per-lane allowlist (lane axis {lane})")
        return None


def lint_batched_fn(name, fn, args, batched) -> List[LintFinding]:
    """Lint one batched kernel: ``batched`` maps argument positions to the
    lane axis they carry.  Returns the (possibly empty) finding list."""
    gm = make_fx(fn, tracing_mode="real")(*args)
    # map flattened inputs back to argument positions
    lanes: List[Lane] = []
    for i, a in enumerate(args):
        leaves = torch.utils._pytree.tree_leaves(a)
        lanes.extend([batched.get(i)] * len(leaves))
    w = _Walker(name)
    w.walk(gm.graph, lanes)
    return w.findings


def lint_app(app) -> Dict[str, List[LintFinding]]:
    """Lint every declared batched kernel of one app."""
    out: Dict[str, List[LintFinding]] = {}
    for k in app.batched_kernels():
        out[k.name] = lint_batched_fn(
            f"{app.name}/{k.name}", k.fn, k.args, dict(k.batched)
        )
    return out
