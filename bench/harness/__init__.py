"""The benchmark's general parts: finding a cell's files, the inputs,
the serving loop, the trace, the work and peaks, the output check."""
