"""The plan cache of K1-K5 (``repro_torch.kernels.autotune``) against the
reference's ``repro.kernels.autotune``, on the CPU.

The reference's side is kept to one model at 32 px: its ``zoo_signatures``
traces every program of the model.  The card's side (timing, cached plans
launched, their bits) is in ``tests/test_torch_cuda.py``.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels import autotune as ref_at
from repro_torch.core.arch import DUAL_BASELINE, BoardModel
from repro_torch.core.scheduler import build_schedule
from repro_torch.dualcore.runtime import DualCoreRunner
from repro_torch.kernels import autotune as at
from repro_torch.kernels.conv_gemm.plan import plan_k1
from repro_torch.models.cnn import init_params, params_from_numpy
from repro_torch.models.zoo import get_graph
from repro_torch.serving.cnn import stream_images

ROOT = Path(__file__).resolve().parents[1]
MODEL = "mobilenet_v1"
SIZE = 32
KINDS = ("pointwise", "conv", "depthwise", "fused_dw_pw", "fused_pw_dw_pw")
CARD = "cuda/NVIDIA H100 80GB HBM3/sm90"
FIELDS = ("kind", "H", "W", "C_i", "C_o", "K_h", "K_w", "stride", "pad",
          "dtype")
#: one signature of each kind at a shape the served path launches (224 px,
#: batch 2)
PATH_SIGS = {
    "pointwise": at.LayerSig("pointwise", 56, 56, 64, 128, N=2),
    "conv": at.LayerSig("conv", 55, 55, 16, 64, 3, 3, 1, 1, N=2, vec=True),
    "depthwise": at.LayerSig("depthwise", 112, 112, 32, 32, 3, 3, 1, 1,
                             N=2),
    "fused_dw_pw": at.LayerSig("fused_dw_pw", 14, 14, 512, 512, 3, 3, 1, 1,
                               N=2),
    "fused_pw_dw_pw": at.LayerSig("fused_pw_dw_pw", 28, 28, 192, 32, 3, 3,
                                  1, 1, N=2, C_e=32),
}


@pytest.fixture(autouse=True)
def _fresh():
    at.clear_memory_cache()
    at.reset_lookups()
    yield
    at.clear_memory_cache()


@pytest.fixture(scope="module")
def ref_sigs():
    return ref_at.zoo_signatures(SIZE, models=(MODEL,))


@pytest.fixture(scope="module")
def port_sigs():
    return {"all": at.zoo_signatures(SIZE, (MODEL,), 1),
            "programs": at.zoo_signatures(SIZE, (MODEL,), 1,
                                          group_schemes=())}


def _port(ref_sig) -> at.LayerSig:
    return at.LayerSig(**{f: getattr(ref_sig, f) for f in FIELDS})


@pytest.mark.parametrize("kind", KINDS)
def test_key_matches_the_reference_over_zoo_signatures(kind, ref_sigs,
                                                       port_sigs):
    """``key()`` byte for byte the reference's; the port's programs ask for
    the reference's signatures and the group-fused plans add the rest."""
    mine = [s for s in ref_sigs if s.kind == kind]
    if kind != "fused_pw_dw_pw":          # v1 has no inverted residual
        assert mine
    for s in mine:
        assert _port(s).key() == s.key()
    ref_keys = {s.key() for s in ref_sigs if s.kind == kind}
    programs = {s.key() for s in port_sigs["programs"] if s.kind == kind}
    every = {s.key() for s in port_sigs["all"] if s.kind == kind}
    assert programs == ref_keys
    assert ref_keys <= every
    group_only = every - programs
    if kind in ("fused_dw_pw", "fused_pw_dw_pw", "pointwise"):
        assert all(k.startswith(kind) for k in group_only)


def test_group_fused_plans_add_signatures(port_sigs):
    """The runner's group fusion asks for fused blocks the whole-program
    fusion does not (a chain cut by a core boundary)."""
    extra = {s.key() for s in port_sigs["all"]} - \
        {s.key() for s in port_sigs["programs"]}
    assert extra
    assert {k.split("/")[0] for k in extra} <= set(KINDS)


def test_a_served_request_asks_only_for_zoo_signatures(port_sigs):
    graph = get_graph(MODEL)
    params = params_from_numpy(init_params(graph), "cpu")
    sched = build_schedule(graph, DUAL_BASELINE, BoardModel(), "balanced")
    runner = DualCoreRunner(MODEL, params, sched, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, SIZE, SIZE, 3)).astype(np.float32))
    with at.record_signatures() as rec:
        out = stream_images(runner, [x]).outputs
    assert out[0].shape == (1, 1000)
    assert rec and set(rec) <= set(port_sigs["all"])
    assert at.LOOKUPS == {"hit": 0, "miss": 0}     # the CPU resolves none


def test_entry_key_carries_what_the_plans_depend_on():
    sig = PATH_SIGS["pointwise"]
    tag = CARD + "/sms64"
    assert sig.entry_key(tag) == (
        "pointwise/h56.w56.ci64.co128.k1x1.s1.p0/f32/n2@cuda/NVIDIA H100 "
        "80GB HBM3/sm90/sms64")
    assert PATH_SIGS["fused_pw_dw_pw"].entry_key("cpu").endswith(
        "/n2.ce32@cpu")
    assert PATH_SIGS["conv"].entry_key("cpu").endswith("/n2.v1@cpu")
    other = sig._replace(N=1)
    assert other.key() == sig.key() and \
        other.entry_key(tag) != sig.entry_key(tag)
    assert at.dtype_name(torch.float32) == "float32"


# --------------------------------------------------------------------------
# the reference's semantics (tests/test_fused_block.py), with stub runs
# --------------------------------------------------------------------------
def _fake_card(monkeypatch, tag: str) -> None:
    """Calls on ``cuda:0`` look up entries of ``tag``, on the CPU."""
    monkeypatch.setattr(at, "device_tag", lambda device=None: tag)
    monkeypatch.setattr(at, "_stream_sms", lambda index: None)


def _timed(monkeypatch):
    """Time a stub run as the number it returns (no clock)."""
    monkeypatch.setattr(at, "_time_us", lambda fn, dev: fn())


def test_roundtrip_deterministic(tmp_path):
    path = str(tmp_path / "autotune.json")
    sig = at.LayerSig("conv", 8, 8, 8, 8, 3, 3, 1, 1, vec=True)
    cfg = at.tune_layer(sig, device="cpu", path=path, reps=1)
    assert cfg in at.candidates(sig)
    with open(path) as f:
        raw = json.load(f)
    assert raw["version"] == at.CACHE_VERSION
    entry = raw["entries"][sig.entry_key("cpu")]
    assert entry["config"] == cfg and entry["backend"] == "cpu"
    assert len(entry["candidates_us"]) == len(at.candidates(sig))
    at.clear_memory_cache()
    assert at.get_config(sig, path=path, device="cpu") == cfg

    def boom(_cfg):
        raise AssertionError("re-timed despite a cache hit")
    assert at.tune(sig, boom, path=path, device="cpu") == cfg


def test_force_retimes_and_caches_the_fastest(tmp_path, monkeypatch):
    _timed(monkeypatch)
    path = str(tmp_path / "autotune.json")
    sig = PATH_SIGS["pointwise"]
    cands = at.candidates(sig)
    assert len(cands) > 2
    first = at.tune(sig, lambda cfg: lambda: 10.0 + cands.index(cfg),
                    path=path, device="cpu")
    assert first == cands[0]
    seen = []

    def run(cfg):
        seen.append(cfg)
        return lambda: 5.0 if cfg == cands[2] else 9.0
    assert at.tune(sig, run, path=path, device="cpu") == cands[0]
    assert seen == []
    assert at.tune(sig, run, path=path, device="cpu", force=True,
                   reps=2) == cands[2]
    assert seen == cands
    entry = at.load_cache(path)["entries"][sig.entry_key("cpu")]
    assert entry["us"] == 5.0
    assert entry["candidates_us"][2] == [5.0, 5.0]


def test_a_failing_candidate_is_skipped(tmp_path, monkeypatch):
    _timed(monkeypatch)
    path = str(tmp_path / "autotune.json")
    sig = PATH_SIGS["depthwise"]
    cands = at.candidates(sig)

    def run(cfg):
        if cfg == cands[1]:
            raise RuntimeError("refused")
        return lambda: 1.0 if cfg == cands[1] else 3.0 + cands.index(cfg)
    assert at.tune(sig, run, path=path, device="cpu") == cands[0]
    entry = at.load_cache(path)["entries"][sig.entry_key("cpu")]
    assert entry["candidates_us"][1] is None and entry["us"] == 3.0


def test_all_candidates_failing_caches_the_pick_untimed(tmp_path):
    path = str(tmp_path / "autotune.json")
    sig = PATH_SIGS["fused_dw_pw"]

    def run(cfg):
        raise RuntimeError("every candidate refused")
    cfg = at.tune(sig, run, path=path, device="cpu")
    assert cfg == at.heuristic_config(sig)
    entry = at.load_cache(path)["entries"][sig.entry_key("cpu")]
    assert entry["us"] is None
    with open(path) as f:
        assert json.load(f)["entries"][sig.entry_key("cpu")]["us"] is None


def test_a_miss_gives_none_and_the_planner_pick(tmp_path, monkeypatch):
    path = str(tmp_path / "empty.json")
    sig = PATH_SIGS["pointwise"]
    assert at.get_config(sig, path=path, device="cpu") is None
    _fake_card(monkeypatch, CARD + "/sms132")
    got = at.resolve(sig, torch.device("cuda", 0), path)
    assert got is plan_k1(2 * 56 * 56, 64, 128)
    assert at.LOOKUPS == {"hit": 0, "miss": 1}


@pytest.mark.parametrize("theirs,mine", [
    (CARD + "/sms64", "cpu"), ("cpu", CARD + "/sms64"),
    (CARD + "/sms64", CARD + "/sms68"), (CARD + "/sms64", CARD + "/sms132"),
    ("cuda/NVIDIA A100-SXM4-80GB/sm80/sms108", CARD + "/sms132")])
def test_another_tags_entry_is_a_miss(tmp_path, monkeypatch, theirs, mine):
    path = str(tmp_path / "autotune.json")
    sig = PATH_SIGS["fused_pw_dw_pw"]
    data = at.load_cache(path)
    data["entries"][sig.entry_key(theirs)] = {
        "config": at.candidates(sig)[1], "us": 1.0, "backend": theirs}
    # an entry under this tag's key but tuned elsewhere is a miss too
    data["entries"][sig.entry_key(mine)] = {
        "config": at.candidates(sig)[1], "us": 1.0, "backend": theirs}
    at.save_cache(data, path)
    _fake_card(monkeypatch, mine)
    assert at.get_config(sig, path=path) is None
    if mine != "cpu":
        assert at.resolve(sig, torch.device("cuda", 0), path) is \
            at.planner_plan(sig)


def test_a_hit_is_resolved_once_a_generation(tmp_path, monkeypatch):
    path = str(tmp_path / "autotune.json")
    sig = PATH_SIGS["conv"]
    tag = CARD + "/sms64"
    _fake_card(monkeypatch, tag)
    cands = at.candidates(sig)
    data = at.load_cache(path)
    data["entries"][sig.entry_key(tag)] = {"config": cands[3], "us": 2.0,
                                           "backend": tag}
    at.save_cache(data, path)
    dev = torch.device("cuda", 0)
    got = at.resolve(sig, dev, path)
    assert at.knobs(sig, got) == cands[3]
    reads = []
    monkeypatch.setattr(at, "_entry",
                        lambda *a: reads.append(a) or None)
    assert at.resolve(sig, dev, path) is got
    assert reads == [] and at.LOOKUPS == {"hit": 2, "miss": 0}
    at.save_cache(at.load_cache(path), path)      # a new generation
    assert at.resolve(sig, dev, path) is at.planner_plan(sig)
    assert len(reads) == 1


# --------------------------------------------------------------------------
# the file, shared with the reference
# --------------------------------------------------------------------------
def test_default_path_is_the_ports_own(monkeypatch):
    monkeypatch.delenv(at.CACHE_ENV, raising=False)
    assert at.cache_path() == os.path.join("results",
                                           "autotune_cache_torch.json")
    assert at.cache_path() != ref_at.cache_path()
    assert at.cache_path("x.json") == "x.json"
    monkeypatch.setenv(at.CACHE_ENV, "/elsewhere.json")
    assert at.cache_path() == "/elsewhere.json"


def test_the_file_is_shared_with_the_reference(tmp_path, monkeypatch):
    _timed(monkeypatch)
    path = str(tmp_path / "shared.json")
    ref_at.clear_memory_cache()
    ref_sig = ref_at.LayerSig("conv", 8, 8, 8, 8, 3, 3, 1, 1)
    sig = _port(ref_sig)
    assert at.load_cache(path)["entries"] == {}     # mirrored before
    ref_cfg = ref_at.tune(ref_sig, lambda cfg: lambda: None, path=path,
                          reps=1)
    mine = at.tune(sig, lambda cfg: lambda: 1.0, path=path, device="cpu")
    with open(path) as f:
        raw = json.load(f)
    assert raw["version"] == 1
    assert raw["entries"][ref_sig.key()]["config"] == ref_cfg
    assert raw["entries"][sig.entry_key("cpu")]["config"] == mine
    ref_at.clear_memory_cache()
    assert sig.entry_key("cpu") in ref_at.load_cache(path)["entries"]
    assert ref_at.get_config(ref_sig, path=path) == ref_cfg
    at.clear_memory_cache()
    assert ref_sig.key() in at.load_cache(path)["entries"]
    assert at.get_config(sig, path=path, device="cpu") == mine
    ref_at.clear_memory_cache()


def test_a_file_of_another_version_is_left_empty(tmp_path):
    path = tmp_path / "v2.json"
    path.write_text(json.dumps({"version": 2, "entries": {"a": {}}}))
    assert at.load_cache(str(path)) == {"version": 1, "entries": {}}


# --------------------------------------------------------------------------
# candidates keep the planner's bits
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kind", KINDS)
def test_candidates_keep_the_pick_and_its_reduction_order(kind):
    sig = PATH_SIGS[kind]
    cands = at.candidates(sig)
    assert cands[0] == at.heuristic_config(sig)
    assert at.knobs(sig, at.planner_plan(sig)) == cands[0]
    assert 2 <= len(cands) <= at.MAX_CANDIDATES
    assert len({json.dumps(c, sort_keys=True) for c in cands}) == len(cands)
    ranked = at._ranked(sig)
    pool = [at.knobs(sig, p) for p in ranked]
    order = at.reduction_order(sig, at.planner_plan(sig))
    for c in cands:
        assert c in pool
        assert at.reduction_order(sig, at.plan_of(sig, c)) == order
    # in the planner's order after the pick
    idx = [pool.index(c) for c in cands[1:]]
    assert idx == sorted(idx)
    # a config from outside the candidates raises, naming the entry
    bad = dict(cands[0], smem_bytes=cands[0]["smem_bytes"] + 4)
    with pytest.raises(ValueError, match="not among its candidates"):
        at.plan_of(sig, bad, "the-key in the-file")
    other = [p for p in ranked
             if at.reduction_order(sig, p) != order]
    if kind == "depthwise":
        assert order is None and other == []
    else:
        assert other
        with pytest.raises(ValueError, match="another order"):
            at.plan_of(sig, at.knobs(sig, other[0]), "k")


def test_reduction_order_is_the_kernels():
    """K1/K3: the k ranges of the cluster's ranks; K5: also the expand's
    accumulator sets, two only for a halo of at most 4 m-tiles and one
    chunk a pass."""
    sig = PATH_SIGS["pointwise"]
    p = at.planner_plan(sig)
    assert at.reduction_order(sig, dataclasses.replace(p, bk=16,
                                                       cluster=2)) == \
        ((0, 32), (32, 64))
    k5 = PATH_SIGS["fused_pw_dw_pw"]
    q = at.planner_plan(k5)
    small = dataclasses.replace(q, th=4, tw=4, group=1)      # 6x6 halo
    assert at.reduction_order(k5, small)[1] == 2
    assert at.reduction_order(k5, dataclasses.replace(small, group=2))[1] \
        == 1
    assert at.reduction_order(k5, dataclasses.replace(q, th=8, tw=8))[1] \
        == 1


def test_a_cached_config_outside_the_candidates_raises(tmp_path,
                                                       monkeypatch):
    path = str(tmp_path / "autotune.json")
    sig = PATH_SIGS["fused_dw_pw"]
    tag = CARD + "/sms68"
    _fake_card(monkeypatch, tag)
    data = at.load_cache(path)
    bad = dict(at.candidates(sig)[0], th=3)
    data["entries"][sig.entry_key(tag)] = {"config": bad, "us": 1.0,
                                           "backend": tag}
    at.save_cache(data, path)
    with pytest.raises(ValueError) as err:
        at.resolve(sig, torch.device("cuda", 0), path)
    assert sig.entry_key(tag) in str(err.value) and path in str(err.value)


def test_ops_on_the_cpu_resolve_no_plan(monkeypatch):
    """On CPU tensors the ops record their signature and run the plain
    versions: no device tag is asked for."""
    from repro_torch.kernels.conv_gemm.ops import conv2d_gemm
    from repro_torch.kernels.conv_gemm.ref import conv2d_ref

    def no_tag(device=None):
        raise AssertionError("a plan was resolved on the CPU")
    monkeypatch.setattr(at, "device_tag", no_tag)
    monkeypatch.setattr(at, "_stream_sms", no_tag)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 9, 9, 8), np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, 8, 4), np.float32))
    with at.record_signatures() as rec:
        got = conv2d_gemm(x, w, None, stride=2, pad=1, act="relu")
    assert torch.equal(got, conv2d_ref(x, w, None, stride=2, pad=1,
                                       act="relu"))
    assert [s.kind for s in rec] == ["conv"] and rec[0].N == 2 \
        and rec[0].vec


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------
def test_sweep_zoo_cli_on_the_cpu(tmp_path, capsys):
    path = tmp_path / "cache.json"
    assert at.main(["--sweep-zoo", "--device", "cpu", "--image-size",
                    str(SIZE), "--batch", "1", "--limit", "3", "--reps",
                    "1", "--cache", str(path)]) == 0
    entries = json.loads(path.read_text())["entries"]
    assert len(entries) == 3
    assert all(k.endswith("@cpu") and e["backend"] == "cpu"
               for k, e in entries.items())
    out = capsys.readouterr().out
    assert "3 tuned" in out and "0 already cached" in out
    assert at.main(["--sweep-zoo", "--device", "cpu", "--image-size",
                    str(SIZE), "--batch", "1", "--limit", "1", "--reps",
                    "1", "--cache", str(path)]) == 0
    assert "3 already cached, 1 tuned" in capsys.readouterr().out
    assert len(json.loads(path.read_text())["entries"]) == 4


def test_sweep_zoo_cli_needs_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        at.main(["--sweep-zoo", "--smoke", "--cache",
                 str(tmp_path / "c.json")])
    assert not (tmp_path / "c.json").exists()


def test_the_module_runs_as_a_script(tmp_path):
    """``python -m`` reaches the canonical module, so recording works."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.kernels.autotune",
         "--sweep-zoo", "--device", "cpu", "--image-size", "16", "--batch",
         "1", "--limit", "1", "--reps", "1", "--cache",
         str(tmp_path / "c.json")],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "1 tuned" in proc.stdout


def test_sweep_zoo_cli_splits_only_the_card(tmp_path):
    with pytest.raises(SystemExit):
        at.main(["--sweep-zoo", "--device", "cpu", "--theta", "0.5",
                 "--cache", str(tmp_path / "c.json")])
    assert not (tmp_path / "c.json").exists()


@pytest.mark.parametrize("split", [["--c-sms", "80"],
                                   ["--theta", "0.5", "--c-sms", "80"]],
                         ids=["c-sms", "theta-and-c-sms"])
def test_sweep_zoo_cli_takes_one_split_on_the_card(tmp_path, split):
    """``--c-sms`` splits the card as ``--theta`` does, and the two
    exclude each other."""
    with pytest.raises(SystemExit):
        at.main(["--sweep-zoo", "--device", "cpu", *split, "--cache",
                 str(tmp_path / "c.json")])
    assert not (tmp_path / "c.json").exists()
