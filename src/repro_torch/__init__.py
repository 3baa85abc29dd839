"""PyTorch/CUDA port of the Colmena reproduction.

Mirrors the layout of the JAX package ``repro`` module for module, but
imports neither ``jax`` nor anything of ``repro``: what it needs from a
framework-free ``repro`` module it keeps as its own copy. Entry points run
on the CUDA device unless the caller asks for the CPU; hand-written Hopper
kernels live under ``repro_torch.kernels`` and are built at first use.
"""
