"""Port of ``repro.kernels.conv_gemm``."""
