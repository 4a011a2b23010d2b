"""Port of ``repro.configs``: the architectures the port can run."""
