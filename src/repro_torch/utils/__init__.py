from repro_torch.utils import timing, trees
