"""What the benchmark measures with, kept apart from the program: reading
the profiler's trace and counting a launch's least time."""
