"""CPU tests that the benchmark never runs without a card and that a run
and the reference load neither JAX nor the JAX package (the reference not
the port either): each in a fresh interpreter."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

from bench.tests.cells import ROOT, tiny_root


def test_run_refuses_to_start_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        "mnv2.offline.b64", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 2
    assert p.stdout.strip() == ""
    assert "does not run on the CPU" in p.stderr


ISOLATION = """
import json, sys, time
from pathlib import Path
sys.path[:0] = [{root!r}]
import torch
{body}
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def top_level_modules(body: str, root: Path) -> set[str]:
    p = subprocess.run([sys.executable, "-c",
                        ISOLATION.format(root=str(root), body=body)],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    root = tiny_root(tmp_path)
    mods = top_level_modules(
        "from bench.harness.cell import load_cell\n"
        "from bench.harness.measure import run_cell\n"
        "import bench.run\n"
        f"cell = load_cell('tiny.alone', Path({str(root)!r}))\n"
        "run_cell(cell, 3, 0.2, False, torch.device('cpu'),"
        " time.perf_counter())\n", ROOT)
    assert "repro_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_nothing_of_either_package():
    mods = top_level_modules(
        "from bench.harness.cell import load_file\n"
        "from bench.harness.inputs import make_inputs\n"
        "from bench.harness.check import forward_of, reference_logits\n"
        "for name in ('mobilenet_v2', 'mobilenet_v1'):\n"
        "    cfg = json.loads(Path(f'bench/configs/{name}.json')"
        ".read_text())\n"
        "    cfg['image_px'] = 32\n"
        "    ref = load_file(Path(f'bench/reference/{name}.py'))\n"
        "    t, fwd = ref.layers(cfg), forward_of(ref)\n"
        "    params, pool = make_inputs(t, cfg, {'pool': 1, 'batch': 2}, 1,"
        " torch.device('cpu'))\n"
        "    reference_logits(fwd, t, params, pool, [0])\n"
        "    reference_logits(fwd, t, params, pool, [0], 'tf32')\n", ROOT)
    assert not mods & {"jax", "jaxlib", "flax", "repro", "repro_torch"}
