"""Port of ``repro.kernels.fused_block``."""
