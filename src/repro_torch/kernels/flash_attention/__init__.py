"""Blockwise online-softmax attention (prefill)."""
