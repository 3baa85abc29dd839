"""PyTorch/CUDA port of the Colmena reproduction.

Mirrors the layout of the JAX package ``repro`` module for module, but
imports neither ``jax`` nor anything of ``repro``: what it needs from a
framework-free ``repro`` module it keeps as its own copy. Entry points run
on the CUDA device unless the caller asks for the CPU; hand-written Hopper
kernels live under ``repro_torch.kernels`` and are built at first use.
"""
import os as _os

import torch as _torch

# torch's CPU exp, sin, cos, tanh, sqrt and other vector math call MKL's VML
# where torch is built with MKL. When the first such call of a process is
# made by several OpenMP threads at once, some threads' chunks can come back
# accurate only to about 1e-4 relative, against 6e-8 on every later call
# (MKL 2024.2 in the torch 2.13 CPU wheel on an AVX-512 Xeon: about one
# fresh process in twelve). One call on one thread first avoids it for the
# whole process.
_torch.exp(_torch.zeros(1))

# torch's CPU ops run on an OpenMP thread pool, which does not survive fork:
# a child forked after the parent ran a parallel op hangs in its first one
# (libgomp). The fabric forks its broker, pool workers and inference shards
# and keeps `fork` as its start method, so every forked child of a process
# that imported the port runs torch's CPU ops on one thread.
_os.register_at_fork(after_in_child=lambda: _torch.set_num_threads(1))
