"""What every cell shares: the cell's files, the window, the profiler's
reduction, the peaks of the card and the result line."""
