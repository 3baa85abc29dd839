from repro_torch.optim import adamw, clip, compress, schedules  # noqa: F401
