"""Plain references that decide a run's ``correct``. They import neither
``jax`` nor anything of ``repro`` or ``repro_torch``, and take nothing the
program computed: only the inputs and weights the benchmark made, and the
program's outputs, which they read to judge them."""
