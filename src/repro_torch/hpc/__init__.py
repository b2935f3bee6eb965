"""Region-structured HPC applications, ported to torch.

Every app of the JAX suite: sor, heat, cg, pagerank, kmeans, mg and
montecarlo (and, through the suite registry, the model stack's lm-train and
decode).
"""
from typing import Dict

from ..core.regions import IterativeApp
from .cg import CGApp
from .heat import HeatApp
from .kmeans import KMeansApp
from .mg import MGApp
from .montecarlo import MonteCarloApp
from .pagerank import PageRankApp
from .sor import SORApp

_REGISTRY: Dict[str, type] = {
    "cg": CGApp,
    "heat": HeatApp,
    "kmeans": KMeansApp,
    "mg": MGApp,
    "montecarlo": MonteCarloApp,
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


__all__ = ["get_app", "app_names", "CGApp", "HeatApp", "KMeansApp", "MGApp", "MonteCarloApp",
           "PageRankApp", "SORApp"]
