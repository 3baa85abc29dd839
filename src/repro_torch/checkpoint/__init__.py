from repro_torch.checkpoint import manager, store  # noqa: F401
