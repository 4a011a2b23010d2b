"""Port of ``repro.serving``."""
