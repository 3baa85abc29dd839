"""The dense-adjacency MPNN message step."""
