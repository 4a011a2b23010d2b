"""A throwaway cell for the CPU tests, made from new files only."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"


def tiny_root(tmp_path: Path, reference: str | None = None) -> Path:
    """A checkout of the benchmark with a tiny cell added from new files
    only: a configuration, a traffic mix, a loop and a metric; and, where
    ``reference`` gives its source, a reference module
    ``reference/tiny_ref.py`` that the configuration names."""
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", root)
    shutil.copytree(BENCH, root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / "mobilenet_v1.json").read_text())
    cfg["image_px"] = 32
    if reference is not None:
        (root / "bench/reference/tiny_ref.py").write_text(reference)
        cfg["reference"] = "tiny_ref"
    (root / "bench/configs/tiny_v1.json").write_text(json.dumps(cfg))
    (root / "bench/traffic/tiny.json").write_text(json.dumps(
        {"loop": "alone", "clients": 3, "batch": 2, "pool": 3,
         "latency_cap_s": 10.0}))
    (root / "bench/loops/alone.py").write_text(
        (BENCH / "loops" / "closed.py").read_text())
    (root / "bench/metrics/slots.tiny.py").write_text(
        "def read(run):\n    return run.window.slots\n")
    spec["configs"].append({"name": "tiny_v1", "source": "test",
                            "file": "bench/configs/tiny_v1.json",
                            "reduced": ["image_px"], "why": "test"})
    spec["workloads"].append({"name": "tiny.alone", "config": "tiny_v1",
                              "traffic": "tiny", "chips": 1,
                              "why": "test"})
    spec["per_layer"].append({"name": "slots.tiny", "unit": "slots",
                              "better": "higher",
                              "source": "program_counter", "layer": "test",
                              "moves": "img_per_s",
                              "workloads": ["tiny.alone"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root
