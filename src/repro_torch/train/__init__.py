"""Port of ``repro.train``: optimizers, checkpoints and the runner."""
