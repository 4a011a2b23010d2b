"""Telemetry: replay-deterministic metrics and their exposition.

Copy of ``repro/obs`` (stdlib only).  The fleet's executor and router
instrument through one :class:`Registry` per top-level engine; metrics in
the ``slot`` domain are a pure function of the instruction stream (a
replay's snapshot equals the live run's), those in the ``wall`` domain are
observational.  ``docs/observability.md`` lists the metrics.
"""
from repro_torch.obs.export import to_json, to_prometheus, write_metrics
from repro_torch.obs.registry import (DEFAULT_COUNT_BOUNDS,
                                      DEFAULT_SECONDS_BOUNDS, Counter, Gauge,
                                      Histogram, Registry, parse_label_key)

__all__ = ["Counter", "Gauge", "Histogram", "Registry",
           "DEFAULT_COUNT_BOUNDS", "DEFAULT_SECONDS_BOUNDS",
           "parse_label_key", "to_json", "to_prometheus", "write_metrics"]
