"""Streaming posterior updates (paper Sec. 6), the serving engine, and
their multi-tenant forms (the fleet's masked mutations, ``GPFleetEngine``)."""
from .fleet_engine import GPFleetEngine
from .gp_engine import GPServeEngine, Query, propose_via_engine
from .updates import (evict, fleet_evict, fleet_insert, fleet_resync, insert,
                      maybe_resync, refresh_local_cache, resync_gband,
                      with_capacity)

__all__ = ["insert", "evict", "with_capacity", "refresh_local_cache",
           "maybe_resync", "resync_gband", "GPServeEngine", "Query",
           "propose_via_engine", "fleet_insert",
           "fleet_evict", "fleet_resync", "GPFleetEngine"]
