"""The port stands alone: no module of ``repro_torch`` (nor ``chip_smoke.py``)
imports JAX or the reference package ``repro``, and the entry points refuse
to run on the CPU unless the caller asks for it."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.arch import DUAL_BASELINE, BoardModel
from repro_torch.core.scheduler import build_schedule
from repro_torch.dualcore.runtime import DualCoreRunner
from repro_torch.models.cnn import build_model, init_params, params_from_numpy
from repro_torch.models.zoo import get_graph

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
sys.path.insert(0, {root!r})
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.startswith("jax") or m == "repro" or m.startswith("repro."))
print(len(names))
print(bad)
"""


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env.update(extra)
    return env


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top.startswith("jax") or top == "repro"


def test_importing_the_port_loads_no_jax_and_no_reference():
    out = subprocess.run([sys.executable, "-c",
                          _PROBE.format(root=str(ROOT))],
                         env=_env(), capture_output=True, text=True,
                         timeout=120, check=True).stdout.splitlines()
    assert int(out[0]) >= 25          # every module of the package was seen
    assert out[1] == "[]"


#: the port's examples, beside the reference's four
EXAMPLES = ("quickstart_torch", "serve_dualmesh_torch", "train_lm_torch",
            "design_space_search_torch")


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    [*PORT.rglob("*.py"), ROOT / "chip_smoke.py",
     *(ROOT / "examples" / f"{e}.py" for e in EXAMPLES)]))
def test_no_source_imports_jax_or_reference(path):
    """Covers imports inside functions too, which the probe above cannot
    see unless they run."""
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, names)


def test_entry_points_without_device_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    graph = get_graph("squeezenet")
    sched = build_schedule(graph, DUAL_BASELINE, BoardModel(), "balanced")
    cpu_params = params_from_numpy(init_params(graph), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model("squeezenet")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DualCoreRunner("squeezenet", cpu_params, sched)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({"fc": {"w": np.zeros((1, 1, 2, 2), np.float32)}})
    from repro_torch.launch.serve import main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["cnn", "squeezenet", "--image-size", "32"])


def test_lm_entry_points_without_device_raise_without_a_card(monkeypatch):
    """The ``lm`` subcommand and the LM building blocks need a card unless
    the caller passes ``device="cpu"`` (``--device cpu``)."""
    from repro_torch.configs.registry import get_smoke
    from repro_torch.dualmesh.partition import split_streams
    from repro_torch.launch.serve import main
    from repro_torch.dualmesh.search import card_model
    from repro_torch.lm.model import init_cache, load_params

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke("qwen2_0_5b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["lm", "--arch", "qwen2_0_5b"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        split_streams()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_params(cfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        card_model()
    assert split_streams("cpu").stream("p") is None
    assert init_cache(cfg, 1, 8, device="cpu").kv_k.device.type == "cpu"


#: the fleet slice's modules: each a copy of the reference module at the
#: same path, importing neither JAX nor ``repro``
FLEET_MODULES = ("core/area", "core/search", "obs/__init__", "obs/registry",
                 "obs/export", "fleet/__init__", "fleet/pool",
                 "fleet/router", "fleet/planner", "fleet/instructions",
                 "fleet/compiler", "fleet/faults", "fleet/net/__init__",
                 "fleet/net/wire", "fleet/net/transport", "fleet/executor",
                 "fleet/engine", "fleet/trace", "fleet/net/worker",
                 "fleet/net/coordinator", "fleet/worker", "fleet/control")


@pytest.mark.parametrize("name", FLEET_MODULES)
def test_fleet_modules_are_the_ports_own(name):
    """Each fleet-slice module exists in the port beside its reference
    counterpart (the probe imports it; the source scan reads it)."""
    assert (PORT / f"{name}.py").is_file()
    assert (ROOT / "src" / "repro" / f"{name}.py").is_file()


#: the LM slices' modules, the design flow, the MoE configs and the SSM,
#: hybrid, encoder-decoder and M-RoPE families among them:
#: each a copy of the reference module at the same path, importing neither
#: JAX nor ``repro``
LM_MODULES = ("lm/config", "lm/modules", "lm/model", "dualmesh/__init__",
              "dualmesh/partition", "dualmesh/cost", "dualmesh/schedule",
              "dualmesh/search", "dualmesh/runtime", "serving/lm",
              "configs/registry", "configs/qwen2_0_5b", "configs/qwen2_5_14b",
              "configs/granite_20b", "configs/command_r_plus_104b",
              "configs/qwen2_moe_a2_7b", "configs/granite_moe_3b_a800m",
              "lm/ssm", "configs/xlstm_350m", "configs/zamba2_2_7b",
              "configs/whisper_small", "configs/qwen2_vl_72b")


@pytest.mark.parametrize("name", LM_MODULES)
def test_lm_modules_are_the_ports_own(name):
    """Each LM-slice module exists in the port beside its reference
    counterpart (the probe imports it; the source scan reads it)."""
    assert (PORT / f"{name}.py").is_file()
    assert (ROOT / "src" / "repro" / f"{name}.py").is_file()


def test_fleet_entry_points_raise_without_a_card(monkeypatch):
    """The pool, ``build_cnn_fleet`` and ``serve fleet`` need a card unless
    the caller passes ``device="cpu"`` (``--device cpu``)."""
    from repro_torch.fleet import DevicePool, build_cnn_fleet
    from repro_torch.launch.serve import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DevicePool()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_cnn_fleet(["squeezenet"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["fleet", "--models", "sqz", "--image-size", "32"])
    assert DevicePool("cpu").cores.streams == {"c": None, "p": None}


def test_chip_smoke_fails_without_a_card(tmp_path):
    """No card: a non-zero exit and no result on stdout, in the checkout
    and in a directory that holds the script alone."""
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (lone, tmp_path)):
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                              env=_env(CUDA_VISIBLE_DEVICES=""),
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert proc.stdout == ""
