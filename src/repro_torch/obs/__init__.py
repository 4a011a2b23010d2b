"""Telemetry: replay-deterministic metrics and their exposition.

Copy of ``repro/obs`` (stdlib only), and the port's own host spans
(``spans.py``).  The fleet's executor and router instrument through one
:class:`Registry` per top-level engine; metrics in the ``slot`` domain are
a pure function of the instruction stream (a replay's snapshot equals the
live run's), those in the ``wall`` domain are observational.  The CNN
engine's spans go to a :class:`SpanRecorder` and its counters to its own
registry, both off by default.  ``docs/observability.md`` lists the
metrics, ``docs/observability_torch.md`` the spans and the engine's
counters.
"""
from repro_torch.obs.export import to_json, to_prometheus, write_metrics
from repro_torch.obs.registry import (DEFAULT_COUNT_BOUNDS,
                                      DEFAULT_SECONDS_BOUNDS, Counter, Gauge,
                                      Histogram, Registry, parse_label_key)
from repro_torch.obs.spans import Span, SpanRecorder

__all__ = ["Counter", "Gauge", "Histogram", "Registry",
           "DEFAULT_COUNT_BOUNDS", "DEFAULT_SECONDS_BOUNDS",
           "parse_label_key", "to_json", "to_prometheus", "write_metrics",
           "Span", "SpanRecorder"]
