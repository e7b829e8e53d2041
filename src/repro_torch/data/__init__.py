"""Deterministic synthetic data and a prefetching iterator."""
