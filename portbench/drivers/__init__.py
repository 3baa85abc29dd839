"""General drivers, one per kind of entry that a window drives. A traffic
file names its driver; a new mix of an existing kind is a data file only.

Every driver module defines ``Bench(cell, seed, device)`` with:

- ``setup(win)``: inputs and weights from the seed, the program, the
  warm-up of every shape the cell's traffic uses, and anything the
  correctness check needs the program to have done before the window
  (``win`` is the window, not yet open);
- ``run(win)``: the measured window (``harness/window.py``);
- ``release()``: frees the program's state, after the peak is read;
- ``end_to_end(win)``: the cell's end-to-end metrics, by name;
- ``context(win, trace)``: what the per-layer readers read;
- ``check()``: {name: (value, limit)}, each number compared and its limit;
- ``attempted``, ``failed``: units of work tried and failed in the window;
- ``close()``: stops every thread the bench started.
"""
