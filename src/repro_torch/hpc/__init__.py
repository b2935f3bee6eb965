"""Region-structured HPC applications, ported to torch.

``sor`` is the only app ported so far; :func:`get_app` names the ROADMAP item
for every other app of the JAX suite.
"""
from typing import Dict

from ..core.regions import IterativeApp
from .sor import SORApp

_REGISTRY: Dict[str, type] = {
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


__all__ = ["get_app", "app_names", "SORApp"]
