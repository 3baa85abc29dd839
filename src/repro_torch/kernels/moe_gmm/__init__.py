"""Grouped (per-expert) matmul for the MoE FFN."""
