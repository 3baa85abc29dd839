"""Mamba2 state-space-dual (SSD) chunked scan (prefill)."""
