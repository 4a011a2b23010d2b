"""The port's examples (``examples/*_torch.py``) on the CPU: each imports
only ``repro_torch`` of this repository (``tests/test_torch_isolation.py``
scans them for JAX and the reference), and the quickstart and the design
flow run end to end at their smallest sizes."""
import ast
import importlib.util
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart_torch", "serve_dualmesh_torch", "train_lm_torch",
            "design_space_search_torch")


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def one_thread():
    """One intra-op thread: the examples' small products are slower on
    several threads of a shared host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_imports_the_port_and_takes_a_device(name):
    tree = ast.parse((ROOT / "examples" / f"{name}.py").read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    assert "repro_torch" in tops
    assert tops <= {"repro_torch", "argparse", "numpy", "torch", "os",
                    "tempfile"}
    assert (ROOT / "examples" / f"{name[:-len('_torch')]}.py").is_file()
    assert '"--device", default="cuda"' in \
        (ROOT / "examples" / f"{name}.py").read_text()


def test_quickstart_on_the_cpu(capsys, one_thread):
    _load("quickstart_torch").main(["--device", "cpu", "--image-size",
                                    "32"])
    out = capsys.readouterr().out
    assert "P(128,9) baseline: 757,817 cycles" in out
    assert "PyTorch forward on cpu: logits (1, 1000), finite=True" in out


def test_design_space_search_on_the_cpu(capsys, one_thread):
    _load("design_space_search_torch").main(["--device", "cpu",
                                             "--smoke"])
    out = capsys.readouterr().out
    assert "[fpga] best config" in out and "img/s measured (32px, cpu)" \
        in out
    assert "of 132 SMs)" in out and "on 256 abstract cards" in out


def test_examples_need_a_card_without_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load("quickstart_torch").main(["--image-size", "32"])
