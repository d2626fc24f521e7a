"""Deterministic synthetic data."""
