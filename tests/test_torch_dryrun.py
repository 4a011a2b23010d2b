"""The port's one-card dry run (``launch/dryrun.py``), its roofline model
(``launch/roofline_model.py``) and the registry's cells, against the JAX
reference on the CPU.

- ``SHAPES``, ``LONG_OK`` and ``cells()`` equal the reference's, in its
  order;
- ``hbm_bytes_per_device`` equals the reference's to 1e-12 relative on all
  ten published configs x the four shapes x chips {1, 256} x
  ``kv_bytes_per_elem`` {1, 2};
- ``microbatches_for`` and ``model_flops`` equal the reference's over every
  cell.  The reference's ``launch/dryrun.py`` sets ``XLA_FLAGS`` to 512 host
  devices when it is imported, which would change every later JAX test in
  the worker, so it is asked in one subprocess;
- ``run_cell`` on ``meta`` for Qwen2-0.5B's three shapes and xLSTM's
  ``long_500k``: the keys, the counted operations against the model's
  (below), and no memory allocated;
- ``grad_dtype=torch.bfloat16`` (the reference's ``grads_bf16`` policy,
  ``--grads-bf16``) on Qwen2-0.5B's ``train_4k`` (two microbatches): the
  bf16 accumulator takes at least half the f32 parameters' bytes off the
  tracked peak, and the roofline model's gradient read exactly that;
- :class:`LiveBytes` against a hand count on a small autograd program;
- the CLI writes a cell's JSON.

``useful_flops_ratio`` is ``model_flops`` over the operations counted on
``meta``.  The train and decode cells hold it in (0, 1.05].  Two cells
count less than the reference's formula for reasons outside the port:
the prefill's kernel counts the (query, key) pairs its causal mask leaves,
about half of ``model_flops``' S x S square, so there the square is halved
before the ratio is held in (0, 1.05] (the raw ratio is about 1.59); and
xLSTM's untied embedding is a lookup, not the 2 V d FLOPs a token
``model_flops`` counts for it, so there those are taken off first (the raw
ratio is about 1.18).
"""
from __future__ import annotations

import functools
import json
import os
import resource
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro.configs import registry as ref_registry
from repro.launch.roofline_model import hbm_bytes_per_device as ref_hbm
from repro_torch.configs import registry
from repro_torch.launch import dryrun
from repro_torch.launch.roofline_model import hbm_bytes_per_device

ROOT = Path(__file__).resolve().parents[1]
RUN_CELLS = [("qwen2_0_5b", "train_4k"), ("qwen2_0_5b", "prefill_32k"),
             ("qwen2_0_5b", "decode_32k"), ("xlstm_350m", "long_500k")]
KEYS = ("arch", "shape", "kind", "mesh", "chips", "seq", "batch",
        "microbatches", "flops_per_device", "model_flops",
        "useful_flops_ratio", "hbm_bytes_per_device", "per_device_bytes",
        "fits_hbm", "t_compute_s", "t_memory_s", "t_collective_s", "ok")


def test_registry_shapes_and_cells_match_reference():
    assert registry.SHAPES == ref_registry.SHAPES
    assert registry.LONG_OK == ref_registry.LONG_OK
    assert registry.ARCH_IDS == ref_registry.ARCH_IDS
    assert registry.cells() == ref_registry.cells()
    assert registry.cells(include_long=False) == ref_registry.cells(False)


@pytest.mark.parametrize("arch", ref_registry.ARCH_IDS)
def test_hbm_bytes_per_device_matches_reference(arch):
    cfg, rcfg = registry.get_arch(arch), ref_registry.get_arch(arch)
    for seq, batch, kind in ref_registry.SHAPES.values():
        for chips in (1, 256):
            for kvb in (1.0, 2.0):
                for mb in (1, 4):
                    want = ref_hbm(rcfg, kind, seq, batch, chips, mb, kvb)
                    got = hbm_bytes_per_device(cfg, kind, seq, batch, chips,
                                               mb, kvb)
                    assert got == pytest.approx(want, rel=1e-12, abs=0)


_REF_POLICY = """
import json
from repro.configs.registry import SHAPES, cells, get_arch
from repro.launch import dryrun
out = []
for arch, shape in cells():
    seq, batch, kind = SHAPES[shape]
    cfg = get_arch(arch)
    out.append([arch, shape, dryrun.microbatches_for(cfg, batch, 16),
                dryrun.microbatches_for(cfg, batch, 32),
                dryrun.model_flops(cfg, kind, seq, batch)])
print(json.dumps(out))
"""


def test_microbatches_and_model_flops_match_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    done = subprocess.run([sys.executable, "-c", _REF_POLICY], env=env,
                          capture_output=True, text=True, timeout=300,
                          check=True)
    want = json.loads(done.stdout.strip().splitlines()[-1])
    assert len(want) == len(registry.cells())
    for arch, shape, mb16, mb32, mf in want:
        seq, batch, kind = registry.SHAPES[shape]
        cfg = registry.get_arch(arch)
        assert dryrun.microbatches_for(cfg, batch, 16) == mb16
        assert dryrun.microbatches_for(cfg, batch, 32) == mb32
        assert dryrun.model_flops(cfg, kind, seq, batch) == mf


class _RealAllocations(TorchDispatchMode):
    """The bytes of every output not on ``meta`` (each view counted)."""

    def __init__(self):
        super().__init__()
        self.nbytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.device.type != "meta":
                self.nbytes += t.numel() * t.element_size()
        return out


def _held_flops(cfg, kind, seq, batch, mf):
    """``model_flops`` less what the reference's formula counts that no
    implementation computes (module docstring)."""
    if kind == "prefill" and cfg.block_type == "transformer":
        return mf - 2.0 * cfg.n_layers * batch * seq * seq * cfg.q_dim
    if not cfg.tie_embeddings and cfg.block_type != "transformer":
        return mf - 2.0 * cfg.vocab * cfg.d_model * batch * (
            seq if kind in ("train", "prefill") else 1)
    return mf


@functools.lru_cache(maxsize=None)
def _run_cell(arch, shape, grad_dtype=None):
    """``run_cell``'s result, and the bytes it allocated off ``meta`` and
    its growth of the process's peak RSS (KiB), from its first call."""
    real = _RealAllocations()
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    with real:
        res = dryrun.run_cell(arch, shape, verbose=False,
                              grad_dtype=grad_dtype)
    grown_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - rss
    return res, real.nbytes, grown_kb


@pytest.mark.parametrize("arch,shape", RUN_CELLS)
def test_run_cell_on_meta(arch, shape):
    res, real_bytes, grown_kb = _run_cell(arch, shape)
    assert real_bytes < 2 ** 20 and grown_kb < 2 ** 20
    for key in KEYS:
        assert key in res, key
    cfg = registry.get_arch(arch)
    seq, batch, kind = registry.SHAPES[shape]
    assert (res["mesh"], res["chips"], res["t_collective_s"]) == ("h100", 1,
                                                                   0.0)
    assert (res["seq"], res["batch"], res["kind"]) == (seq, batch, kind)
    assert res["microbatches"] == (dryrun.microbatches_for(cfg, batch)
                                   if kind == "train" else 1)
    assert res["flops_per_device"] == res["matmul_flops"] + sum(
        res["kernel_ops"].values())
    ratio = res["useful_flops_ratio"]
    assert ratio == pytest.approx(res["model_flops"]
                                  / res["flops_per_device"])
    held = _held_flops(cfg, kind, seq, batch, res["model_flops"])
    assert 0 < held / res["flops_per_device"] <= 1.05
    if kind in ("train", "decode"):
        assert 0 < ratio <= 1.05
    assert res["per_device_bytes"] > 0
    assert res["fits_hbm"] == (res["per_device_bytes"] < 80 * 10 ** 9)
    assert res["t_compute_s"] == pytest.approx(
        res["flops_per_device"] / 67e12)
    assert res["t_memory_s"] == pytest.approx(
        res["hbm_bytes_per_device"] / 3.35e12)
    assert res["hbm_bytes_per_device"] == pytest.approx(hbm_bytes_per_device(
        cfg, kind, seq, batch, 1, res["microbatches"], 4.0), rel=1e-12)


def test_run_cell_grads_bf16_moves_peak_and_hbm():
    f32, _, _ = _run_cell("qwen2_0_5b", "train_4k")
    bf16, real_bytes, grown_kb = _run_cell("qwen2_0_5b", "train_4k",
                                           torch.bfloat16)
    assert real_bytes < 2 ** 20 and grown_kb < 2 ** 20
    assert f32["microbatches"] == bf16["microbatches"] == 2
    assert (f32["grad_dtype"], bf16["grad_dtype"]) == ("float32",
                                                      "bfloat16")
    half = 2 * registry.get_arch("qwen2_0_5b").param_count()
    assert f32["per_device_bytes"] - bf16["per_device_bytes"] >= half
    assert f32["hbm_bytes_per_device"] - bf16["hbm_bytes_per_device"] == \
        pytest.approx(half, rel=1e-12)
    assert f32["flops_per_device"] == bf16["flops_per_device"]


def test_live_bytes_hand_count():
    """y = 2 x; z = exp(y); s = sum(z); ds/dx, on meta, x of 1000 floats.
    By hand: x is 4000 bytes; the forward adds y, z (autograd saves z for
    exp's gradient) and s, 12004 in all.  The backward adds the 4-byte
    seed of s's gradient (expanded as a view), exp's gradient z * g (4000,
    y's gradient) and mul's 2 g (4000, x's): a peak of 20008.  Then the
    seed and y's gradient die, leaving x, y, z, s and dx (16004); dropping
    the names leaves x."""
    meta = torch.device("meta")
    x = torch.empty(1000, device=meta, requires_grad=True)
    live = dryrun.LiveBytes()
    live.track(x)
    assert live.current == live.peak == 4000
    with torch.enable_grad(), live:
        y = x * 2
        z = y.exp()
        s = z.sum()
        assert live.current == live.peak == 12004
        (gx,) = torch.autograd.grad(s, x)
        assert live.peak == 20008
    live.sweep()
    assert live.current == 16004
    del y, z, s, gx
    live.sweep()
    assert live.current == 4000 and live.peak == 20008


def test_dryrun_cli_writes_a_cell(tmp_path):
    assert dryrun.main(["--arch", "xlstm_350m", "--shape", "long_500k",
                        "--out", str(tmp_path)]) == 0
    res = json.loads((tmp_path / "xlstm_350m.long_500k.h100.json")
                     .read_text())
    assert res["ok"] and res["mesh"] == "h100"
    assert res["grad_dtype"] == "float32"
    assert dryrun.main(["--arch", "xlstm_350m", "--shape", "long_500k",
                        "--grads-bf16", "--out", str(tmp_path)]) == 0
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "xlstm_350m"])
