"""Streaming posterior updates (paper Sec. 6) and the serving engine."""
from .gp_engine import (GPServeEngine, PosteriorHealthError, Query,
                        propose_via_engine)
from .updates import (evict, insert, maybe_resync, refresh_local_cache,
                      resync_gband, with_capacity)

__all__ = ["insert", "evict", "with_capacity", "refresh_local_cache",
           "maybe_resync", "resync_gband", "GPServeEngine", "Query",
           "PosteriorHealthError", "propose_via_engine"]
