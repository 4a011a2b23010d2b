"""Port of ``repro.dualcore``."""
