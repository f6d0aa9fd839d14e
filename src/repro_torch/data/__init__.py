"""Synthetic data sources (numpy)."""
from .synthetic import rastrigin, sample_test_function, schwefel

__all__ = ["schwefel", "rastrigin", "sample_test_function"]
