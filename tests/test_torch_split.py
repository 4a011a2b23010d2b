"""The c/p split of the card's SMs (``repro_torch.kernels.green``) on the
CPU: the c-core's count against the reference's Eq.10 split, CUDA's
granularity and the realised theta, the ``ctypes`` plumbing against a fake
``libcuda`` that refuses, and the cores and pools on the CPU, which split
nothing.  The split on the card: ``tests/test_torch_cuda.py`` (``-k
split``) and ``chip_smoke.py``.
"""
import ctypes
import math

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.dualmesh.partition import abstract_split
from repro_torch.dualcore.runtime import DualCores
from repro_torch.fleet.pool import DevicePool
from repro_torch.kernels import green

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
