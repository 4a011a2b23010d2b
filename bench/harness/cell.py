"""A cell's pieces, found by name under the benchmark's folder.

``BENCHMARK.json`` names the cell's configuration and traffic mix; the
configuration file names its program adapter (``programs/<program>.py``)
and reference (``reference/<reference>.py``); the traffic file names its
loop (``loops/<loop>.py``); each metric is read by ``metrics/<name>.py``.
A new cell, mix, loop, program or metric is a new file and a new entry,
with no edit to a file that is there.  So is a new reference: a module
whose ``layers(cfg)`` gives its table and which may define its own plain
``forward`` (``reference/plain.py`` states both contracts), named by the
configuration that uses it."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parents[1]      # the benchmark's folder
ROOT = HERE.parent                              # the checkout

_LOADED: dict[Path, ModuleType] = {}


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    root: Path
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]       # the metric entries this cell reports
    per_layer: list[dict]

    @property
    def bench(self) -> Path:
        """The benchmark's folder in this checkout."""
        return self.root / HERE.name

    def part(self, kind: str, name: str) -> ModuleType:
        """Module ``<kind>/<name>.py`` of the benchmark's folder."""
        return load_file(self.bench / kind / f"{name}.py")


def load_file(path: Path) -> ModuleType:
    """Import the Python file ``path`` once (names may hold dots)."""
    path = path.resolve()
    mod = _LOADED.get(path)
    if mod is None:
        if not path.is_file():
            raise FileNotFoundError(f"no such benchmark file: {path}")
        name = "bench_part_" + re.sub(r"\W", "_", str(path))
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return mod


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str, root: Path | None = None) -> Cell:
    """Cell ``name`` of ``<root>/BENCHMARK.json`` (root: this checkout)."""
    root = Path(root) if root is not None else ROOT
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"choices: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads(
        (root / HERE.name / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(root=root, name=name, chips=int(w["chips"]), config=config,
                traffic=traffic,
                end_to_end=[m for m in spec["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in spec["per_layer"]
                           if _applies(m, name)])
