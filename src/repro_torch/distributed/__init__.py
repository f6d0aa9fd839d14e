"""Sharding rules, tree placement and elastic re-meshing on torch meshes."""
from .sharding import (  # noqa: F401
    batch_pspecs,
    cache_pspecs,
    fleet_pspecs,
    shardings_for,
    spec_for_axes,
)
