"""Batched decode serving engine (continuous slot-based batching)."""
from .engine import ServeEngine  # noqa: F401
