"""Port of ``repro.data``: the synthetic token stream."""
