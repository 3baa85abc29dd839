"""Steering policies (numpy only)."""
