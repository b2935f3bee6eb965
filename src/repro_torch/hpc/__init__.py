"""Region-structured HPC applications, ported to torch.

Ported so far: sor, heat, cg, pagerank and kmeans (and, through the suite
registry, the model stack's lm-train and decode); :func:`get_app` names the
ROADMAP item of every other app of the JAX suite.
"""
from typing import Dict

from ..core.regions import IterativeApp
from .cg import CGApp
from .heat import HeatApp
from .kmeans import KMeansApp
from .pagerank import PageRankApp
from .sor import SORApp

_REGISTRY: Dict[str, type] = {
    "cg": CGApp,
    "heat": HeatApp,
    "kmeans": KMeansApp,
    "pagerank": PageRankApp,
    "sor": SORApp,
}


def app_names():
    """Every registered (ported) app name; delegates to :mod:`.suite`."""
    from . import suite

    return list(suite.app_names())


def get_app(name: str, **kwargs) -> IterativeApp:
    """Instantiate a registered app; kwargs override the default problem."""
    from . import suite

    return suite.get_app(name, **kwargs)


__all__ = ["get_app", "app_names", "CGApp", "HeatApp", "KMeansApp", "PageRankApp", "SORApp"]
