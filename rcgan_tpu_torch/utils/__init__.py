"""Host utilities: run directories, metrics, summaries, image grids and
PNGs, profiling (numpy, the standard library and torch)."""
