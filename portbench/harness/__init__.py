"""The benchmark's general machinery: finding a cell's pieces by name,
drawing its inputs from the seed, timing, reading the trace, and the
result line."""
