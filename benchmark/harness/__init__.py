"""The harness that drives one cell: manifest lookups, the traffic
generator and its feeder process, the measured window with its spans,
and the profiler trace."""
