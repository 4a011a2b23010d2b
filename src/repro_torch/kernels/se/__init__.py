"""The squeeze-and-excitation gate: the port's own kernel (EfficientNet)."""
