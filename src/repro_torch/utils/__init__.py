from repro_torch.utils import timing  # noqa: F401
