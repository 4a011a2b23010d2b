"""Port of ``repro.kernels``."""
