"""Exposition: registry snapshots as Prometheus text or JSON.

Both formats render the same
:meth:`repro_torch.obs.registry.Registry.snapshot` dict.  The ``domain``
of every metric rides along (Prometheus: a ``# HELP``-line suffix; JSON:
the ``domain`` field) so a reader can tell replay-deterministic values
from wall-clock ones.  Copy of ``repro/obs/export.py``.
"""
from __future__ import annotations

import json
import sys

from repro_torch.obs.registry import Registry, parse_label_key


def _prom_labels(key: str, extra: dict | None = None) -> str:
    labels = parse_label_key(key)
    if extra:
        labels.update(extra)
    if not labels:
        return ""
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return "{" + inner + "}"


def to_prometheus(snapshot: dict) -> str:
    """Render a snapshot in the Prometheus text exposition format
    (text/plain version 0.0.4): counters and gauges one sample per label
    set, histograms as cumulative ``_bucket{le=...}`` + ``_sum`` +
    ``_count`` families."""
    lines: list[str] = []
    for name, entry in snapshot.get("counters", {}).items():
        lines.append(f"# HELP {name} {entry.get('help', '')} "
                     f"[domain={entry.get('domain', '?')}]")
        lines.append(f"# TYPE {name} counter")
        for key, v in entry.get("series", {}).items():
            lines.append(f"{name}{_prom_labels(key)} {_num(v)}")
    for name, entry in snapshot.get("gauges", {}).items():
        lines.append(f"# HELP {name} {entry.get('help', '')} "
                     f"[domain={entry.get('domain', '?')}]")
        lines.append(f"# TYPE {name} gauge")
        for key, v in entry.get("series", {}).items():
            lines.append(f"{name}{_prom_labels(key)} {_num(v)}")
    for name, entry in snapshot.get("histograms", {}).items():
        lines.append(f"# HELP {name} {entry.get('help', '')} "
                     f"[domain={entry.get('domain', '?')}]")
        lines.append(f"# TYPE {name} histogram")
        bounds = entry.get("bounds", [])
        for key, s in entry.get("series", {}).items():
            cum = 0
            for b, c in zip(bounds, s["counts"]):
                cum += c
                lines.append(f"{name}_bucket"
                             f"{_prom_labels(key, {'le': _num(b)})} {cum}")
            cum += s["counts"][len(bounds)] if len(s["counts"]) > \
                len(bounds) else 0
            lines.append(f"{name}_bucket"
                         f"{_prom_labels(key, {'le': '+Inf'})} {cum}")
            lines.append(f"{name}_sum{_prom_labels(key)} {_num(s['sum'])}")
            lines.append(f"{name}_count{_prom_labels(key)} {s['n']}")
    return "\n".join(lines) + "\n"


def _num(v) -> str:
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return str(v)


def to_json(snapshot: dict) -> str:
    """Render a snapshot as deterministic JSON (sorted keys)."""
    return json.dumps(snapshot, indent=1, sort_keys=True)


def write_metrics(registry_or_snapshot, path: str,
                  domain: str | None = None) -> str:
    """Write one exposition of ``registry_or_snapshot`` to ``path``:
    ``-`` streams Prometheus text to stdout, a ``.json`` suffix selects
    JSON, anything else Prometheus text.  Returns the format used
    (``"prom"`` or ``"json"``)."""
    snap = (registry_or_snapshot.snapshot(domain)
            if isinstance(registry_or_snapshot, Registry)
            else registry_or_snapshot)
    if path == "-":
        sys.stdout.write(to_prometheus(snap))
        return "prom"
    if path.endswith(".json"):
        with open(path, "w") as f:
            f.write(to_json(snap) + "\n")
        return "json"
    with open(path, "w") as f:
        f.write(to_prometheus(snap))
    return "prom"
