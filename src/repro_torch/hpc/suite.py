# Port of repro/hpc/suite.py: the registry holds the HPC apps of
# hpc/__init__.py and the model stack's lm-train and decode, registered
# lazily.  CI_SIZES, BENCH_SIZES, FAULT_SWEEP_APPS and the cache sizing are
# copied unchanged.
"""Suite-level helpers: canonical cache sizing + CI-sized app instances.

The cache-capacity : working-set ratio is the lever that controls how long
dirty blocks linger (and therefore how much EasyCrash's flushes matter).  The
paper chooses inputs whose footprint exceeds the LLC; we default to a cache
holding ~60 % of one iteration's working set, which reproduces the paper's
regime where natural write-backs keep *most* — but not all — of NVM
consistent.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

from ..core.cache_sim import CacheConfig
from ..core.regions import IterativeApp, object_blocks
from . import _REGISTRY as _HPC_REGISTRY


_APP_FACTORIES: Dict[str, Callable[..., IterativeApp]] = dict(_HPC_REGISTRY)

#: apps of the JAX package's registry that the port does not have yet, with
#: the ROADMAP item that ports each (none left)
NOT_PORTED: Dict[str, str] = {}


def register_app(name: str, factory: Callable[..., IterativeApp]) -> None:
    """Register (or replace) an app factory under ``name``.

    ``factory(**params)`` must return an :class:`IterativeApp`; app classes
    themselves qualify.
    """
    if not callable(factory):
        raise TypeError(f"factory for {name!r} must be callable")
    _APP_FACTORIES[str(name)] = factory


# the model stack's apps register lazily, so importing the suite never pulls
# in the transformer
def _lm_train_factory(**params) -> IterativeApp:
    from ..models.train_app import LMTrainApp

    return LMTrainApp(**params)


def _decode_factory(**params) -> IterativeApp:
    from ..models.serve_app import DecodeApp

    return DecodeApp(**params)


register_app("lm-train", _lm_train_factory)
register_app("decode", _decode_factory)


def app_names() -> Tuple[str, ...]:
    return tuple(sorted(_APP_FACTORIES))


def get_app(name: str, **params) -> IterativeApp:
    """Instantiate a registered app by name."""
    try:
        factory = _APP_FACTORIES[name]
    except KeyError:
        if name in NOT_PORTED:
            raise NotImplementedError(
                f"app {name!r} is not ported to torch yet (ROADMAP, {NOT_PORTED[name]})"
            ) from None
        raise KeyError(f"unknown app {name!r}; have {list(app_names())}") from None
    return factory(**params)


#: CI-sized problem instances (small enough for seconds-scale campaigns)
CI_SIZES: Dict[str, dict] = {
    "cg": dict(grid=24, n_iters=300),
    "mg": dict(grid=32, n_iters=24),
    "kmeans": dict(n_points=600, n_iters=8),
    "montecarlo": dict(batch=1024, n_iters=10),
    "heat": dict(grid=32, n_iters=300),
    "sor": dict(grid=24, n_iters=120),
    "pagerank": dict(n_nodes=192, n_iters=100),
    "lm-train": dict(n_iters=10, batch=2, seq=16, width=32),
    "decode": dict(n_iters=12, batch=2, prompt_len=8, width=32),
}

#: apps of the fault-model sweep: a spectrum pick — structured-grid smoothers
#: (mg, sor), a hot-object clustering code (kmeans) and an irregular graph
#: workload (pagerank).
FAULT_SWEEP_APPS = ("mg", "kmeans", "sor", "pagerank")

#: benchmark-sized instances (paper-figure campaigns, minutes-scale)
BENCH_SIZES: Dict[str, dict] = {
    "cg": dict(grid=48, n_iters=600),
    "mg": dict(grid=48, n_iters=24),
    "kmeans": dict(n_points=4000, n_iters=10),
    "montecarlo": dict(batch=8192, n_iters=24),
    "heat": dict(grid=48, n_iters=600),
    "sor": dict(grid=48, n_iters=240),
    "pagerank": dict(n_nodes=512, n_iters=120),
    "lm-train": dict(n_iters=30, batch=4, seq=32, width=64),
    "decode": dict(n_iters=32, batch=4, prompt_len=16, width=64),
}


def working_set_blocks(app: IterativeApp, block_bytes: int = 64) -> int:
    state = app.init(0)
    names = set()
    for r in app.regions():
        names.update(r.reads)
        names.update(r.writes)
    blocks = object_blocks(state, [n for n in names if n in state], block_bytes)
    return sum(blocks.values())


def default_cache(app: IterativeApp, ratio: float = 0.45, block_bytes: int = 64) -> CacheConfig:
    ws = working_set_blocks(app, block_bytes)
    return CacheConfig(capacity_blocks=max(8, int(ws * ratio)), block_bytes=block_bytes)


def ci_app(name: str, **overrides) -> IterativeApp:
    kw = dict(CI_SIZES[name])
    kw.update(overrides)
    return get_app(name, **kw)


def bench_app(name: str, **overrides) -> IterativeApp:
    kw = dict(BENCH_SIZES[name])
    kw.update(overrides)
    return get_app(name, **kw)
