"""The c/p split of the card's SMs (``repro_torch.kernels.green``) on the
CPU: the c-core's count against the reference's Eq.10 split, CUDA's
granularity and the realised theta, the ``ctypes`` plumbing against a fake
``libcuda`` that refuses, the cores and pools on the CPU, which split
nothing, and the measured split: the search over synthetic chain times,
the runner's moves through it on fake split cores, and the runners that
measure nothing.  The split on the card: ``tests/test_torch_cuda.py``
(``-k split``) and ``chip_smoke.py``.
"""
import ctypes
import math
import types

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.dualmesh.partition import abstract_split
from repro_torch.core.arch import DUAL_BASELINE, BoardModel
from repro_torch.core.scheduler import build_schedule
from repro_torch.dualcore import runtime
from repro_torch.dualcore.runtime import DualCoreRunner, DualCores, Lane
from repro_torch.fleet.pool import DevicePool
from repro_torch.kernels import green
from repro_torch.models.cnn import init_params, params_from_numpy
from repro_torch.models.zoo import get_graph
from repro_torch.obs import Registry, SpanRecorder

H100_SMS = 132


@pytest.mark.parametrize("theta", [i / 40 for i in range(1, 40)]
                         + [0.001, 0.004, 0.3, 0.7, 0.996, 0.999])
def test_reference_count_is_the_references_split(theta):
    """Before CUDA's rounding, the c-core's SMs are the reference's
    c-chips of a pod of 132, and the realised shares agree."""
    ref = abstract_split(H100_SMS, theta)
    n_c = green.reference_count(theta, H100_SMS)
    assert n_c == math.prod(ref.c_mesh.shape.values())
    assert H100_SMS - n_c == math.prod(ref.p_mesh.shape.values())
    assert n_c / H100_SMS == ref.theta


@settings(max_examples=200)
@given(st.integers(1, 999), st.integers(16, 200))
def test_granular_count_rounds_to_the_granule(theta_milli, sms):
    """The asked count is a multiple of 8 within one granule of each end,
    the nearest to the reference's count unless that end clamps it."""
    theta = theta_milli / 1000
    n_c = green.reference_count(theta, sms)
    got = green.split_count(theta, sms)
    assert got % green.GRANULE == 0
    assert green.GRANULE <= got <= sms - green.GRANULE
    top = green.GRANULE * ((sms - green.GRANULE) // green.GRANULE)
    if green.GRANULE <= n_c <= top:
        assert abs(got - n_c) <= green.GRANULE // 2
    else:
        assert got == (green.GRANULE if n_c < green.GRANULE else top)


@pytest.mark.parametrize("n_c,sms,want", [
    (66, 132, 64), (33, 132, 32), (99, 132, 96), (92, 132, 96),
    (84, 132, 88), (1, 132, 8), (131, 132, 120), (12, 132, 16),
    (11, 132, 8), (8, 16, 8)])
def test_granular_count_cases(n_c, sms, want):
    assert green.granular_count(n_c, sms) == want


def test_granular_count_refuses_too_few_sms_and_bad_theta():
    with pytest.raises(ValueError, match="cannot be split"):
        green.granular_count(4, 15)
    for theta in (0.0, 1.0, -0.1):
        with pytest.raises(ValueError, match="theta"):
            green.split_count(theta, H100_SMS)


@pytest.mark.parametrize("c_sms,total", [(64, 132), (32, 132), (96, 132),
                                          (8, 16)])
def test_split_records_the_realised_theta(c_sms, total):
    """The cores record the share CUDA gave, not the one asked."""
    parts = {"c": green.Partition(sms=c_sms, stream=None, capture=None),
             "p": green.Partition(sms=total - c_sms, stream=None,
                                  capture=None)}
    split = green.SmSplit(torch.device("cpu"), total, c_sms, parts)
    assert split.theta == c_sms / total
    assert (split.sms("c"), split.sms("p")) == (c_sms, total - c_sms)


class FakeDriver:
    """A ``libcuda`` whose split call returns ``split_rc`` (on 0, a group
    of the count asked and the rest of 132 SMs); it records the calls made,
    numbers the streams it makes and names CUresult 1 and 801."""

    NAMES = {1: b"CUDA_ERROR_INVALID_VALUE", 801: b"CUDA_ERROR_NOT_SUPPORTED"}

    def __init__(self, split_rc: int, missing: str | None = None):
        self.split_rc = split_rc
        self.calls = []
        self.missing = missing

    def __getattr__(self, name):
        if name == self.missing or not name.startswith("cu"):
            raise AttributeError(name)
        fn = getattr(type(self), "_" + name, None)

        def call(*args):
            self.calls.append(name)
            return fn(self, *args) if fn is not None else 0
        self.__dict__[name] = call
        return call

    def _cuGetErrorName(self, rc, out):
        name = self.NAMES.get(rc)
        if name is None:
            return 1
        out._obj.value = name         # out is byref(c_char_p)
        return 0

    def _cuDeviceGetDevResource(self, dev, res, kind):
        ctypes.c_uint.from_buffer(res, green.SM_COUNT_OFFSET).value = \
            H100_SMS
        return 0

    def _cuDevSmResourceSplitByCount(self, group, n, whole, rest, flags,
                                     count):
        if self.split_rc == 0:
            n._obj.value = 1          # n is byref(c_uint)
            for res, sms in ((group, count), (rest, H100_SMS - count)):
                ctypes.c_uint.from_buffer(res, green.SM_COUNT_OFFSET) \
                    .value = sms
        return self.split_rc

    def _cuGreenCtxStreamCreate(self, out, ctx, flags, priority):
        out._obj.value = self.calls.count("cuGreenCtxStreamCreate")
        return 0


@pytest.fixture
def fake_driver(monkeypatch):
    def install(split_rc, missing=None):
        fake = FakeDriver(split_rc, missing)
        monkeypatch.setattr(green, "_DRIVER", [])
        monkeypatch.setattr(green, "_SPLITS", {})
        monkeypatch.setattr(green, "_STREAM_SMS", {})
        monkeypatch.setattr(green.ctypes, "CDLL", lambda path: fake)
        monkeypatch.setattr(green, "_external_stream",
                            lambda handle, device: ("stream", handle))
        return fake
    return install


@pytest.mark.parametrize("rc,name", [(1, "CUDA_ERROR_INVALID_VALUE"),
                                     (801, "CUDA_ERROR_NOT_SUPPORTED"),
                                     (999, "unknown CUresult")])
def test_a_refused_split_raises_naming_the_cuda_result(fake_driver, rc,
                                                       name):
    fake = fake_driver(rc)
    with pytest.raises(green.GreenContextError,
                       match=rf"cuDevSmResourceSplitByCount\(64 of 132 "
                             rf"SMs\) failed: {name} \({rc}\)"):
        green.split_sms(torch.device("cuda", 0), 0.5)
    assert fake.calls[-2:] == ["cuDevSmResourceSplitByCount",
                               "cuGetErrorName"]
    assert "cuGreenCtxCreate" not in fake.calls


def test_a_libcuda_without_green_contexts_raises(fake_driver):
    fake_driver(0, missing="cuGreenCtxStreamCreate")
    with pytest.raises(green.GreenContextError,
                       match="no cuGreenCtxStreamCreate"):
        green.split_sms(torch.device("cuda", 0), 0.5)


def test_a_count_split_before_gives_back_its_split(fake_driver):
    """Each count is split once: splitting at a theta of the same count
    again, as a resplit or a REBALANCE does, returns the same split with
    the same streams and makes no context or stream; a new count makes
    one split of two contexts and four streams."""
    fake = fake_driver(0)
    dev = torch.device("cuda", 0)
    half = green.split_sms(dev, 0.5)
    assert (half.asked, half.sms("c"), half.sms("p")) == (64, 64, 68)
    assert [half.parts[c].stream for c in "cp"] == [("stream", 1),
                                                      ("stream", 3)]
    # each stream's handle, the core's and its capture stream's, names
    # the partition's SMs (the plan cache's key); another stream none
    assert [green.stream_sms(h) for h in (1, 2, 3, 4, 5)] == \
        [64, 64, 68, 68, None]
    made = len(fake.calls)
    assert green.split_sms(dev, 0.48) is half         # 63 SMs -> 64
    assert [c for c in fake.calls[made:]
            if c.startswith(("cuDevSm", "cuGreenCtx"))] == []
    more = green.split_sms(dev, 0.7)
    assert more is not half and more.sms("c") == 96
    assert fake.calls.count("cuDevSmResourceSplitByCount") == 2
    assert fake.calls.count("cuGreenCtxCreate") == 4
    assert fake.calls.count("cuGreenCtxStreamCreate") == 8
    assert green.split_sms(dev, 0.5) is half


def test_cores_on_the_cpu_split_nothing():
    """``sm_split`` (the default) changes nothing on the CPU: both cores
    alias one queue and the theta asked is the one recorded."""
    for kw in ({}, {"sm_split": True}, {"sm_split": False}):
        cores = DualCores(torch.device("cpu"), 0.3, **kw)
        assert cores.streams == {"c": None, "p": None}
        assert not cores.on_card and not cores.distinct
        assert not cores.sm_split and cores.split is None
        assert cores.theta == 0.3 and cores.sms("c") is None
        assert cores.capture_stream("c") is None
        new = cores.resplit(0.7)
        assert new.theta == 0.7 and cores.theta == 0.3
        assert new.streams == cores.streams
        assert "alias one cpu queue" in cores.describe()


def test_pool_stats_on_the_cpu_read_as_before():
    pool = DevicePool("cpu", theta=0.4)
    want = {"device": "cpu", "theta": 0.4, "streams": 1,
            "degenerate": True, "sm_split": False, "leases": []}
    assert pool.stats() == want
    pool.lease("mobilenet_v1")
    pool.revoke_all()
    pool.resplit(0.6)
    assert pool.theta == 0.6
    assert pool.stats() == dict(want, theta=0.6)
    assert DevicePool("cpu", sm_split=False).stats()["sm_split"] is False


# --------------------------------------------------------------------------
# the measured split
# --------------------------------------------------------------------------
def _scaling(work_c, work_p, power=1.0, refuse=()):
    """Chain times of cores whose SM-time a slot at the 64/68 split is
    ``work_c`` and ``work_p``, scaling as SMs**``power``; None at the
    counts in ``refuse``."""
    def measure(n):
        if n in refuse:
            return None
        return (work_c / 64 * (64 / n) ** power,
                work_p / 68 * (68 / (H100_SMS - n)) ** power)
    return measure


#: MobileNet v2's and v1's SM-ms a slot by core at 64/68 on an H100
V2, V1 = (290.0, 190.0), (588.0, 267.0)


@pytest.mark.parametrize("measure,want,counts,swept", [
    (_scaling(*V2), 80, [64, 80], True),
    (_scaling(*V1), 88, [64, 88], True),
    (_scaling(*V2, power=0.6), 80, [64, 80], False),
    (_scaling(*V1, power=0.6), 88, [64, 88], False),
    (_scaling(64.0, 68.0), 64, [64], True),
    (_scaling(*V2, refuse={80}), 64, [64, 80], False),
    (_scaling(*V1, refuse={88}), 64, [64, 88], False),
], ids=["linear-v2", "linear-v1", "sublinear-v2", "sublinear-v1", "flat",
        "refused-v2", "refused-v1"])
def test_the_search_finds_the_lowest_bound(measure, want, counts, swept):
    """Over synthetic chain times the search measures the start and the
    count that balances the SM-time measured there, a realisable count,
    and keeps the lower bound; a refused count keeps the start.  Where
    time scales with the SMs (``swept``) it finds what a sweep of every
    count would."""
    got, probes = green.balanced_count(measure, 64, H100_SMS)
    assert got == want and [p.count for p in probes] == counts
    assert all(p.count % green.GRANULE == 0 and 8 <= p.count <= 120
               for p in probes)
    assert [p.refused for p in probes] == [measure(n) is None
                                           for n in counts]
    assert min((p for p in probes if not p.refused),
               key=lambda p: p.bound).count == got
    if swept:
        sweep = [n for n in range(8, 121, 8) if measure(n) is not None]
        assert want == min(sweep, key=lambda n: max(measure(n)))


def _table(times, default=(10.0, 1.0)):
    """A measure reading ``times[n]`` (c busier than p elsewhere)."""
    return lambda n: times.get(n, default)


@pytest.mark.parametrize("times,want,counts", [
    # (10, 9.5) at 64 balances the SM-time there: no second count
    ({64: (10.0, 9.5)}, 64, [64]),
    # the balancing count takes 0.5% off: it wins
    ({64: (10.0, 5.0), 88: (9.95, 7.0)}, 88, [64, 88]),
    # an exact tie keeps the start, the count held
    ({64: (10.0, 5.0), 88: (10.0, 7.0)}, 64, [64, 88]),
    # the balancing count reads worse: the start stays
    ({64: (10.0, 5.0), 88: (8.0, 10.5)}, 64, [64, 88]),
    # MobileNet v1 as an H100 read it
    ({64: (9.401, 4.2), 88: (7.146, 5.9)}, 88, [64, 88]),
], ids=["balanced-start", "gain", "tie-keeps-start", "loss-keeps-start",
        "v1-on-the-card"])
def test_the_search_keeps_the_start_unless_the_jump_is_lower(times, want,
                                                             counts):
    """The balancing count replaces the start only when its bound is
    lower; a tie is the start's."""
    got, probes = green.balanced_count(_table(times), 64, H100_SMS)
    assert [p.count for p in probes] == counts and got == want


def test_the_search_keeps_a_refused_start_and_refuses_a_bad_one():
    got, probes = green.balanced_count(lambda n: None, 64, H100_SMS)
    assert got == 64 and probes == [green.Probe(64)]
    assert probes[0].refused
    for start in (60, 0, 128):
        with pytest.raises(ValueError, match="no count"):
            green.balanced_count(_table({}), start, H100_SMS)


@pytest.fixture(scope="module")
def v1_parts():
    graph = get_graph("mobilenet_v1")
    return (params_from_numpy(init_params(graph, 0), "cpu"),
            build_schedule(graph, DUAL_BASELINE, BoardModel(), "balanced"))


class FakeSplitCores:
    """Split cores of a 132-SM card without a card: ``resplit`` gives the
    cores of the count asked, or raises as a refused split does."""

    def __init__(self, count, refuse=(), fail=None):
        self.device = torch.device("cpu")
        self.count, self.refuse, self.fail = count, refuse, fail
        self.split = types.SimpleNamespace(total=H100_SMS)
        self.balance = None

    def sms(self, core):
        return self.count if core == "c" else H100_SMS - self.count

    def resplit(self, theta):
        count = green.split_count(theta, H100_SMS)
        if count in self.refuse:
            raise green.GreenContextError(f"split at {count} refused")
        if self.fail is not None:
            raise self.fail
        return FakeSplitCores(count, self.refuse)


@pytest.mark.parametrize("measure,refuse,want", [
    (_scaling(*V2, power=0.6), (), 80),
    (_scaling(*V1), (), 88),
    (_scaling(*V2), (80,), 64),
    (_table({64: (10.0, 5.0), 88: (8.0, 10.5)}), (), 64),
], ids=["sublinear-v2", "linear-v1", "refused-split", "jump-loses"])
def test_the_runner_moves_to_the_measured_count(v1_parts, monkeypatch,
                                                measure, refuse, want):
    """The runner's search on fake split cores: it ends on the cores of
    the chosen count, its lane pool holding that count's one lane (the
    start's own where the start stays), the
    probes on the cores, one ``runner.probe`` span a count tried inside
    ``runner.balance``, and the gauge and counter set."""
    runner = DualCoreRunner("mobilenet_v1", *v1_parts, device="cpu")
    captured = []

    def new_lane(key):
        captured.append(runner.cores.count)
        return Lane(key=key, x=torch.tensor(runner.cores.count), graphs=[],
                    envs=[])

    monkeypatch.setattr(runner, "_new_lane", new_lane)
    monkeypatch.setattr(runner, "_time_chains",
                        lambda lane: measure(runner.cores.count))
    runner.cores = FakeSplitCores(64, refuse)
    runner.lanes = runtime.LanePool(runner._new_lane)
    runner.obs, runner.spans = Registry(), SpanRecorder(enabled=True)
    key = ((64, 224, 224, 3), torch.float32)
    runner._balance_split(key)
    want_got, probes = green.balanced_count(
        lambda n: None if n in refuse else measure(n), 64, H100_SMS)
    assert runner.cores.count == want == want_got
    assert runner.cores.balance == probes
    assert captured == [p.count for p in probes if not p.refused]
    (lane,) = runner.lanes.lanes[key]           # captured at the count
    assert lane.x.item() == want and runner.lanes.acquire(key) is lane
    spans = runner.spans.drain()
    (top,) = [s for s in spans if s.name == "runner.balance"]
    assert [s.parent for s in spans if s.name == "runner.probe"] == \
        [top.sid] * len(probes)
    snap = runner.obs.snapshot()
    assert snap["gauges"]["runner_split_c_sms"]["series"] == {"": want}
    assert snap["counters"]["runner_split_probes_total"]["series"] == \
        {"": len(probes) - 1}
    assert "c count measured" not in DualCores(torch.device("cpu"))\
        .describe()


def test_a_fault_at_the_start_split_raises(v1_parts, monkeypatch):
    """Only another count may refuse: a failure at the split the runner
    starts from is a fault, and raises."""
    runner = DualCoreRunner("mobilenet_v1", *v1_parts, device="cpu")

    def broken(key):
        raise RuntimeError("capture failed")

    monkeypatch.setattr(runner, "_new_lane", broken)
    runner.cores = FakeSplitCores(64)
    runner.lanes = runtime.LanePool(runner._new_lane)
    with pytest.raises(RuntimeError, match="capture failed"):
        runner._balance_split(((1, 32, 32, 3), torch.float32))


@pytest.mark.parametrize("where", ["split", "capture"])
def test_a_fault_at_another_count_raises(v1_parts, monkeypatch, where):
    """Only a refused split makes a count no candidate: another failure
    at the balancing count, in its split or in its lane's capture (out of
    memory here), raises and is not read as a refusal."""
    runner = DualCoreRunner("mobilenet_v1", *v1_parts, device="cpu")
    oom = torch.cuda.OutOfMemoryError("out of memory at 80 SMs")

    def new_lane(key):
        if where == "capture" and runner.cores.count != 64:
            raise oom
        return Lane(key=key, x=torch.tensor(0), graphs=[], envs=[])

    monkeypatch.setattr(runner, "_new_lane", new_lane)
    monkeypatch.setattr(runner, "_time_chains",
                        lambda lane: _scaling(*V2)(runner.cores.count))
    runner.cores = FakeSplitCores(64, fail=oom if where == "split"
                                  else None)
    runner.lanes = runtime.LanePool(runner._new_lane)
    with pytest.raises(torch.cuda.OutOfMemoryError, match="out of memory"):
        runner._balance_split(((1, 32, 32, 3), torch.float32))


@pytest.mark.parametrize("kw", [
    {}, {"theta": 0.3}, {"theta": 0.5}, {"cores": "leased"},
    {"cores": "shared"}, {"cores": "one_stream"}, {"jit_groups": False}],
    ids=["cpu", "theta-0.3", "theta-0.5", "leased", "sm_split-off",
         "one_stream", "eager"])
def test_runners_that_measure_nothing_keep_their_split(v1_parts,
                                                       monkeypatch, kw):
    """On the CPU, and with an explicit theta, leased cores, cores that
    share the SMs, one stream or eager groups, a runner never searches:
    it serves at the split it was given (theta 0.5 without one) and
    records no probe."""
    cpu = torch.device("cpu")
    kw = dict(kw)
    made = {"leased": lambda: DualCores(cpu, 0.7),
            "shared": lambda: DualCores(cpu, 0.4, sm_split=False),
            "one_stream": lambda: DualCores(cpu, 0.6, one_stream=True)}
    if "cores" in kw:
        kw["cores"] = made[kw["cores"]]()
    monkeypatch.setattr(DualCoreRunner, "_balance_split",
                        lambda self, key: pytest.fail("searched"))
    runner = DualCoreRunner("mobilenet_v1", *v1_parts, device="cpu", **kw)
    runner.obs = Registry()
    want = kw["cores"].theta if "cores" in kw else kw.get("theta", 0.5)
    assert runner.cores.theta == want and runner.cores.balance is None
    if "cores" in kw:
        assert runner.cores is kw["cores"]
    runner.run_sequential([torch.randn(1, 32, 32, 3)])
    assert runner.cores.theta == want and runner.cores.balance is None
    snap = runner.obs.snapshot()
    assert "runner_split_probes_total" not in snap["counters"]
    assert "runner_split_c_sms" not in snap["gauges"]
