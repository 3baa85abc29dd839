"""Batched LM serving of the port."""
