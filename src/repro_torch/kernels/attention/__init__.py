"""Port of ``repro.kernels.attention`` (K7, flash and decode)."""
