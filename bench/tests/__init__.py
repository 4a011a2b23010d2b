"""CPU tests of the benchmark (the feeder collects them from the root)."""
