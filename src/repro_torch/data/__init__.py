"""Synthetic data sources (numpy) and the sharded, restartable pipeline."""
from .pipeline import ShardedBatches  # noqa: F401
from .synthetic import (  # noqa: F401
    rastrigin,
    sample_test_function,
    schwefel,
    token_stream,
)

__all__ = ["ShardedBatches", "schwefel", "rastrigin", "sample_test_function",
           "token_stream"]
