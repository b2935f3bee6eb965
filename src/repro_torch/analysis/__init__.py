# Port of repro/analysis/__init__.py: the same exports, less numpy_shim (the
# port's regions keep a tensor state as tensors, so a trace needs no shim),
# with fx_walk in jaxpr_walk's place.
"""Static persist-plan analysis (algorithm-directed characterization).

The W+2 crash-test workflow *measures* which data objects and code regions
are worth persisting.  This package *derives* most of those answers from the
program itself: each region is traced to an aten graph, a dataflow pass
classifies every tracked object (dead-across-crash / reconstructible /
accumulator / crash-critical), and the result is a predicted
:class:`~repro_torch.analysis.classify.StaticPlan` with per-object
confidence — consumed by ``run_workflow(plan_source="static" |
"static+verify" | "adaptive")``.

On the same graphs, :mod:`repro_torch.analysis.determinism_lint` checks
batched step kernels for bitwise-per-lane safety (``python -m
repro_torch.analysis.lint``).
"""
from .classify import (  # noqa: F401
    CONFIDENCE_THRESHOLD,
    DAMPING_THRESHOLD,
    ObjectReport,
    RegionReport,
    StaticPlan,
    analyze_app,
)
from .determinism_lint import LintFinding, lint_app, lint_batched_fn  # noqa: F401
from .fx_walk import RegionTrace, trace_region  # noqa: F401
