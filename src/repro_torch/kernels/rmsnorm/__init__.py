"""Port of ``repro.kernels.rmsnorm`` (K6)."""
