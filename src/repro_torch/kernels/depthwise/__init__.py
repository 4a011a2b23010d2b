"""Port of ``repro.kernels.depthwise``."""
