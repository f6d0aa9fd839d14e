"""Fault-tolerant checkpoints of the port's GPs and fleets."""
from .checkpointer import Checkpointer  # noqa: F401
