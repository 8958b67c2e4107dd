"""Synthetic data generators of the port (numpy only)."""
