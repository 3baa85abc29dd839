"""Synthetic data sources (numpy only)."""
