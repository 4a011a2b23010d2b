"""Zero-dependency metrics registry: counters, gauges, histograms.

One :class:`Registry` instance is owned per top-level engine — the
``PoolExecutor`` creates its own and a ``MultiPoolRouter`` re-homes every
pool executor onto one shared registry, the same move it makes with the
seq counter — so two runs in one process (a live run and its replay)
never bleed into each other.

Every metric lives in one of two **domains**, the contract that keeps
replay honest (DESIGN.md §11-§12 extended to telemetry):

  * ``"slot"`` — a pure function of the instruction stream.  Incremented
    only on paths both live execution and ``router.replay`` pass through
    (``PoolExecutor.execute``, ``_submit_to``, the recovery-event log),
    from values the stream signature already pins (op, core, advances,
    slot).  ``registry.snapshot(domain="slot")`` of a replay is
    dict-equal to the live run's (tested, including crash recovery).
  * ``"wall"`` — observational: wall-clock durations, injector retries,
    spooled bytes, envelope bytes, RTTs, heartbeat misses.  Never
    compared across replay; confined to its own channel so it cannot
    contaminate the deterministic one.

Labels are frozen ``(key, value)`` tuples internally and canonical
``"k=v,k2=v2"`` strings in snapshots (keys sorted); label values must
not contain ``','`` or ``'='``.  Snapshots are plain JSON-able dicts:
what ships over the wire (``telemetry_snap`` envelopes of the fleet's
worker processes), merges across processes (:meth:`Registry.absorb`), and
what :mod:`repro_torch.obs.export` renders.

Copy of ``repro/obs/registry.py``.
"""
from __future__ import annotations

from typing import Mapping

# seconds-scaled bounds: instruction execution on this stack spans
# ~0.1 ms (stub slots) to seconds (a CNN slot behind the kernel build)
DEFAULT_SECONDS_BOUNDS = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2,
                          0.1, 0.3, 1.0, 3.0, 10.0)
# count-scaled bounds (advances per RUN, payloads per SEND)
DEFAULT_COUNT_BOUNDS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0)

DOMAINS = ("slot", "wall")


def _label_key(labels: Mapping[str, str] | None) -> str:
    if not labels:
        return ""
    parts = []
    for k in sorted(labels):
        v = str(labels[k])
        if "," in v or "=" in v:
            raise ValueError(f"label value {v!r} for {k!r} may not "
                             f"contain ',' or '='")
        parts.append(f"{k}={v}")
    return ",".join(parts)


def parse_label_key(key: str) -> dict[str, str]:
    """Invert :func:`_label_key`: ``"a=1,b=2"`` -> ``{"a": "1", "b": "2"}``."""
    if not key:
        return {}
    return dict(p.split("=", 1) for p in key.split(","))


class Counter:
    """Monotonic counter; one value per label set."""

    kind = "counter"

    def __init__(self, registry: "Registry", name: str, help: str,
                 domain: str):
        self.registry = registry
        self.name = name
        self.help = help
        self.domain = domain
        self.series: dict[str, float] = {}

    def inc(self, n: float = 1,
            labels: Mapping[str, str] | None = None) -> None:
        """Add ``n`` (default 1) to the series named by ``labels``."""
        if not self.registry.enabled or n == 0:
            return
        key = _label_key(labels)
        self.series[key] = self.series.get(key, 0) + n


class Gauge:
    """Last-write-wins instantaneous value; one per label set."""

    kind = "gauge"

    def __init__(self, registry: "Registry", name: str, help: str,
                 domain: str):
        self.registry = registry
        self.name = name
        self.help = help
        self.domain = domain
        self.series: dict[str, float] = {}

    def set(self, value: float,
            labels: Mapping[str, str] | None = None) -> None:
        """Set the series named by ``labels`` to ``value``."""
        if not self.registry.enabled:
            return
        self.series[_label_key(labels)] = value


class Histogram:
    """Fixed-bound histogram: per-bucket counts (bucket i counts
    observations ``<= bounds[i]``, non-cumulative internally; the last
    implicit bucket is +Inf), plus sum and count."""

    kind = "histogram"

    def __init__(self, registry: "Registry", name: str, help: str,
                 domain: str, bounds: tuple[float, ...]):
        if list(bounds) != sorted(bounds) or len(set(bounds)) != len(bounds):
            raise ValueError(f"histogram bounds must be strictly "
                             f"increasing (got {bounds})")
        self.registry = registry
        self.name = name
        self.help = help
        self.domain = domain
        self.bounds = tuple(float(b) for b in bounds)
        self.series: dict[str, dict] = {}

    def observe(self, value: float,
                labels: Mapping[str, str] | None = None) -> None:
        """File ``value`` into its bucket for the ``labels`` series."""
        if not self.registry.enabled:
            return
        key = _label_key(labels)
        s = self.series.get(key)
        if s is None:
            s = self.series[key] = {
                "counts": [0] * (len(self.bounds) + 1), "sum": 0.0, "n": 0}
        i = len(self.bounds)                  # +Inf bucket by default
        for j, b in enumerate(self.bounds):
            if value <= b:
                i = j
                break
        s["counts"][i] += 1
        s["sum"] += value
        s["n"] += 1


class Registry:
    """A process-local metric namespace (module docstring).

    ``enabled=False`` turns every ``inc``/``set``/``observe`` into a
    no-op (the switch that measures what the instrumentation costs).
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}
        self._absorbed: dict[str, dict] = {}     # source -> last snapshot

    # ------------------------------------------------------------------
    def _get(self, cls, name: str, help: str, domain: str, **kw):
        if domain not in DOMAINS:
            raise ValueError(f"unknown metric domain {domain!r}; "
                             f"one of {DOMAINS}")
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(self, name, help, domain, **kw)
            return m
        if not isinstance(m, cls) or m.domain != domain:
            raise ValueError(
                f"metric {name!r} re-registered as {cls.__name__.lower()}/"
                f"{domain}, but it is a {m.kind}/{m.domain}")
        return m

    def counter(self, name: str, help: str = "",
                domain: str = "slot") -> Counter:
        """Get or create the counter ``name``."""
        return self._get(Counter, name, help, domain)

    def gauge(self, name: str, help: str = "",
              domain: str = "slot") -> Gauge:
        """Get or create the gauge ``name``."""
        return self._get(Gauge, name, help, domain)

    def histogram(self, name: str, help: str = "", domain: str = "wall",
                  bounds: tuple[float, ...] = DEFAULT_SECONDS_BOUNDS
                  ) -> Histogram:
        """Get or create the histogram ``name`` (fixed ``bounds``)."""
        return self._get(Histogram, name, help, domain, bounds=bounds)

    # ------------------------------------------------------------------
    def snapshot(self, domain: str | None = None, *,
                 sources: bool = True) -> dict:
        """Plain-dict view of every metric (optionally one ``domain``),
        merged with the latest absorbed per-source snapshots (cumulative,
        so counters add and histograms sum; ``sources=False`` restricts
        to this process).  Deterministically ordered: dict-equality of
        two snapshots is the replay-determinism acceptance check."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if domain is not None and m.domain != domain:
                continue
            entry = {"help": m.help, "domain": m.domain,
                     "series": {k: m.series[k] for k in sorted(m.series)}}
            if isinstance(m, Histogram):
                entry["bounds"] = list(m.bounds)
                entry["series"] = {
                    k: {"counts": list(s["counts"]), "sum": s["sum"],
                        "n": s["n"]}
                    for k, s in sorted(m.series.items())}
                out["histograms"][name] = entry
            elif isinstance(m, Gauge):
                out["gauges"][name] = entry
            else:
                out["counters"][name] = entry
        if sources:
            for source in sorted(self._absorbed):
                _merge_into(out, self._absorbed[source], domain)
        return out

    def absorb(self, snapshot: dict, *, source: str) -> None:
        """Adopt a remote registry's cumulative ``snapshot`` (a
        ``telemetry_snap`` payload).  The latest snapshot per ``source``
        *replaces* its predecessor: each ships cumulative totals, so a
        killed worker loses at most the window since its last ship, and
        nothing is counted twice."""
        self._absorbed[source] = snapshot

    @property
    def sources(self) -> list[str]:
        """Names of remote registries absorbed so far."""
        return sorted(self._absorbed)


def _merge_into(out: dict, snap: dict, domain: str | None) -> None:
    """Merge one absorbed snapshot into ``out`` (counters/histograms add,
    gauges last-write-wins, absent metrics adopted whole)."""
    for name, entry in snap.get("counters", {}).items():
        if domain is not None and entry.get("domain") != domain:
            continue
        dst = out["counters"].setdefault(
            name, {"help": entry.get("help", ""),
                   "domain": entry.get("domain", "wall"), "series": {}})
        for k, v in entry.get("series", {}).items():
            dst["series"][k] = dst["series"].get(k, 0) + v
        dst["series"] = {k: dst["series"][k]
                         for k in sorted(dst["series"])}
    for name, entry in snap.get("gauges", {}).items():
        if domain is not None and entry.get("domain") != domain:
            continue
        dst = out["gauges"].setdefault(
            name, {"help": entry.get("help", ""),
                   "domain": entry.get("domain", "wall"), "series": {}})
        dst["series"].update(entry.get("series", {}))
        dst["series"] = {k: dst["series"][k]
                         for k in sorted(dst["series"])}
    for name, entry in snap.get("histograms", {}).items():
        if domain is not None and entry.get("domain") != domain:
            continue
        dst = out["histograms"].setdefault(
            name, {"help": entry.get("help", ""),
                   "domain": entry.get("domain", "wall"),
                   "bounds": list(entry.get("bounds", [])), "series": {}})
        for k, s in entry.get("series", {}).items():
            d = dst["series"].get(k)
            if d is None:
                dst["series"][k] = {"counts": list(s["counts"]),
                                    "sum": s["sum"], "n": s["n"]}
            else:
                d["counts"] = [a + b
                               for a, b in zip(d["counts"], s["counts"])]
                d["sum"] += s["sum"]
                d["n"] += s["n"]
        dst["series"] = {k: dst["series"][k]
                         for k in sorted(dst["series"])}
