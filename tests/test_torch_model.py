"""The port's models, exec plans, runner and engine against the reference.

Weights are seeded He-init numpy arrays (``init_params``), handed to the
reference as ``jnp`` arrays and to the port through ``params_from_numpy``;
images come from numpy seeds.
The port runs with ``device="cpu"``, where every kernel wrapper takes its
plain PyTorch version.

Logits are compared at rtol = atol = 1e-3: each layer agrees at the
kernels' 1e-4 (f32, only the summation order differs: XLA's convolutions
against im2col GEMMs), and the differences compound through up to 53 layers.
Within the port, pipelined and sequential runs are equal bit for bit.
"""
import inspect
import sys
from collections import Counter
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.arch import DUAL_BASELINE as REF_DUAL, BoardModel as RefBoard
from repro.core.scheduler import build_schedule as ref_build_schedule
from repro.dualcore.program import build_program as ref_build_program
from repro.dualcore.runtime import (DualCoreRunner as RefRunner,
                                    build_exec_plan as ref_build_exec_plan)
from repro.models.cnn import FORWARDS as REF_FORWARDS
from repro.models.zoo import get_graph as ref_get_graph
from repro.serving import DualCoreEngine as RefEngine
from repro.serving import Request as RefRequest
from repro.serving import percentile as ref_percentile
from repro.serving import poisson_arrivals as ref_poisson_arrivals
from repro.serving import replay as ref_replay
from repro_torch.core.arch import DUAL_BASELINE, BoardModel
from repro_torch.core.scheduler import build_schedule
from repro_torch.dualcore.program import build_program
from repro_torch.dualcore.runtime import (DualCoreRunner, Lane, LanePool,
                                          build_exec_plan)
from repro_torch.models.cnn import FORWARDS, init_params, params_from_numpy
from repro_torch.models.zoo import get_graph
from repro_torch.serving.api import (EngineBase, FixedRateAdmission,
                                     GreedyAdmission, Request, percentile,
                                     poisson_arrivals, replay)
from repro_torch.serving.cnn import DualCoreEngine

MODELS = ("mobilenet_v1", "mobilenet_v2", "squeezenet")
SCHEMES = ("layer_type", "greedy", "round_robin", "balanced")
TOL = dict(rtol=1e-3, atol=1e-3)
SIZE = 32


def _images(seed, n, size=SIZE, batch=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((batch, size, size, 3)).astype(np.float32)
            for _ in range(n)]


def _jnp(params):
    return {n: {k: jnp.asarray(v) for k, v in p.items()}
            for n, p in params.items()}


def _schedules(model, scheme):
    ref = ref_build_schedule(ref_get_graph(model), REF_DUAL, RefBoard(),
                             scheme)
    port = build_schedule(get_graph(model), DUAL_BASELINE, BoardModel(),
                          scheme)
    return ref, port


@pytest.fixture(scope="module")
def reference():
    """Per model: seeded numpy weights, one input batch, and the
    reference's eager XLA forward of it (logits and collected shapes),
    computed once for the module."""
    out = {}
    for i, model in enumerate(MODELS):
        np_params = init_params(get_graph(model), seed=i)
        (x,) = _images(i, 1)
        collect = {}
        logits = np.asarray(REF_FORWARDS[model](
            _jnp(np_params), jnp.asarray(x), use_pallas=False,
            collect=collect))
        out[model] = dict(params=np_params, x=x, logits=logits,
                          collect=collect)
    return out


# --------------------------------------------------------------------------
# sequential forwards
# --------------------------------------------------------------------------
@pytest.mark.parametrize("model", MODELS)
def test_forward_matches_reference(model, reference):
    ref = reference[model]
    params = params_from_numpy(ref["params"], "cpu")
    collect = {}
    logits = FORWARDS[model](params, torch.from_numpy(ref["x"]),
                             collect=collect)
    assert logits.shape == (2, 1000) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), ref["logits"], **TOL)
    assert collect == ref["collect"]


@pytest.mark.parametrize("model", MODELS)
def test_plain_program_equals_wrapper_program_on_cpu(model, reference):
    """On CPU tensors the wrappers take the plain versions, so the program
    over the wrappers and the all-plain program give the same bits."""
    ref = reference[model]
    params = params_from_numpy(ref["params"], "cpu")
    x = torch.from_numpy(ref["x"])
    a = build_program(model).run(params, x)
    b = build_program(model, plain=True).run(params, x)
    assert torch.equal(a, b)


def test_init_params_is_seeded_he_init():
    g = get_graph("mobilenet_v2")
    a, b = init_params(g, seed=3), init_params(g, seed=3)
    assert a.keys() == {l.name for l in g.layers}
    for l in g.layers:
        np.testing.assert_array_equal(a[l.name]["w"], b[l.name]["w"])
        assert a[l.name]["w"].dtype == np.float32
        assert a[l.name]["b"].shape == (l.C_o,)
    w = a["conv_last"]["w"]
    fan_in = w.shape[0] * w.shape[1] * w.shape[2]
    assert abs(w.std() - (2.0 / fan_in) ** 0.5) < 0.05 * (2.0 / fan_in) ** 0.5
    assert not np.array_equal(init_params(g, seed=4)["fc"]["w"],
                              a["fc"]["w"])


# --------------------------------------------------------------------------
# exec plans
# --------------------------------------------------------------------------
def _plan_view(plan):
    return ([(g.core, [s.name for s in g.steps],
              [tuple(s.layers) for s in g.steps],
              [(tuple(s.reads), tuple(s.writes)) for s in g.steps])
             for g in plan.groups],
            [set(live) for live in plan.live_after],
            plan.exec_schedule.t_b2())


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("model", MODELS)
def test_exec_plan_matches_reference(model, scheme):
    ref_sched, port_sched = _schedules(model, scheme)
    ref = ref_build_exec_plan(
        ref_build_program(model, use_pallas=True, fuse=False), ref_sched,
        group_fusion=True)
    port = build_exec_plan(build_program(model, fuse=False), port_sched,
                           group_fusion=True)
    assert _plan_view(port) == _plan_view(ref)


def _chip_smoke():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


@pytest.mark.parametrize("model,n_groups,launches", [
    ("mobilenet_v1", 11, {"matmul_bias_act": 3, "depthwise_conv2d": 6,
                          "conv2d_implicit_gemm": 1, "fused_dw_pw_conv": 3,
                          "fused_pw_dw_pw_conv": 4}),
    ("mobilenet_v2", 16, {"matmul_bias_act": 29, "depthwise_conv2d": 11,
                          "conv2d_implicit_gemm": 1, "fused_dw_pw_conv": 6}),
    ("squeezenet", 3, {"matmul_bias_act": 17, "conv2d_implicit_gemm": 9})])
def test_balanced_plan_launches(model, n_groups, launches):
    """The main paths' per-request launches, as ``chip_smoke.py`` derives
    them from the exec plan and the graph's layer specs."""
    graph = get_graph(model)
    sched = build_schedule(graph, DUAL_BASELINE, BoardModel(), "balanced")
    plan = build_exec_plan(build_program(model), sched, group_fusion=True)
    assert len(plan.groups) == n_groups
    calls = _chip_smoke().plan_calls(plan, graph, 2)
    assert Counter(c["kernel"] for c in calls) == launches


def test_mobilenet_v2_fused_forward_launches():
    """The ``fuse=True`` sequential forward: 16 inverted residuals on K5,
    b1's dw->pw on K4, the stem on K3, conv_last and fc on K1."""
    graph = get_graph("mobilenet_v2")
    calls = _chip_smoke().step_calls(
        build_program("mobilenet_v2", fuse=True).steps, graph, 2)
    assert Counter(c["kernel"] for c in calls) == {
        "matmul_bias_act": 2, "conv2d_implicit_gemm": 1,
        "fused_dw_pw_conv": 1, "fused_pw_dw_pw_conv": 16}
    assert sum(c["kernel"] == "fused_pw_dw_pw_conv" and c["res"]
               for c in calls) == 10


def test_mobilenet_v2_fused_forward_matches_reference(reference):
    ref = reference["mobilenet_v2"]
    params = params_from_numpy(ref["params"], "cpu")
    collect = {}
    logits = FORWARDS["mobilenet_v2"](params, torch.from_numpy(ref["x"]),
                                      collect=collect, fuse=True)
    np.testing.assert_allclose(logits.numpy(), ref["logits"], **TOL)
    assert collect and all(ref["collect"][k] == v
                           for k, v in collect.items())


def test_plain_fused_program_reaches_no_kernel_wrapper(reference,
                                                       monkeypatch):
    """``plain=True`` holds for the fused steps too: with every kernel
    wrapper the program can reach made to raise, the plain fused program
    of MobileNet v2 still runs, and matches the reference."""
    import repro_torch.dualcore.program as program

    def refuse(*args, **kwargs):
        raise AssertionError("the plain program reached a kernel wrapper")

    for name in ("conv2d_gemm", "depthwise", "fused_dw_pw",
                 "fused_inverted_residual"):
        monkeypatch.setattr(program, name, refuse)
    ref = reference["mobilenet_v2"]
    params = params_from_numpy(ref["params"], "cpu")
    prog = build_program(get_graph("mobilenet_v2"), fuse=True, plain=True)
    assert sum(len(s.layers) == 3 for s in prog.steps) == 16
    out = prog.run(params, torch.from_numpy(ref["x"]))
    np.testing.assert_allclose(out.numpy(), ref["logits"], **TOL)


# --------------------------------------------------------------------------
# the runner and the engine
# --------------------------------------------------------------------------
def _check_cpu_runner(model, reference):
    ref = reference[model]
    params = params_from_numpy(ref["params"], "cpu")
    _, sched = _schedules(model, "balanced")
    runner = DualCoreRunner(model, params, sched, device="cpu")
    assert not runner.cores.distinct
    images = [torch.from_numpy(ref["x"])] + [
        torch.from_numpy(x) for x in _images(7, 2)]
    record = []
    piped = runner.run_pipelined(images, record=record)
    seq = runner.run_sequential(images)
    for a, b in zip(piped, seq):
        assert torch.equal(a, b)
    np.testing.assert_allclose(piped[0].numpy(), ref["logits"], **TOL)
    n_g = len(runner.groups)
    assert [(s, i, g) for s, i, g, _ in record] == [
        (slot, i, slot - i) for slot in range(n_g + 2)
        for i in range(3) if 0 <= slot - i < n_g]
    return runner


def test_cpu_runner_mobilenet_v2_balanced(reference):
    """fuse='group' on the CPU: pipelined equals sequential bit for bit,
    and the first image matches the reference forward."""
    _check_cpu_runner("mobilenet_v2", reference)


def test_cpu_runner_mobilenet_v1_balanced(reference):
    """MobileNet v1 under 'balanced' fuses four pw->dw->pw chains inside
    its groups (K5 on the card): pipelined equals sequential bit for bit,
    and the first image matches the reference forward."""
    runner = _check_cpu_runner("mobilenet_v1", reference)
    assert sum(len(s.layers) == 3 for g in runner.groups
               for s in g.steps) == 4


@pytest.mark.parametrize("model", MODELS)
def test_cpu_runner_jit_groups_and_donate_change_nothing(model, reference):
    """``jit_groups`` and ``donate`` take the reference's names and
    defaults (jit on; donation on a card only), and on the CPU they change
    nothing: pipelined outputs bit-equal with both off and with donation
    forced on, no lane is made, and the outputs match the reference's
    runner with ``jit_groups=True`` at 1e-3."""
    ref = reference[model]
    ref_sched, sched = _schedules(model, "balanced")
    params = params_from_numpy(ref["params"], "cpu")
    for name in ("jit_groups", "donate"):
        assert (inspect.signature(DualCoreRunner).parameters[name].default
                == inspect.signature(RefRunner).parameters[name].default)
    runner = DualCoreRunner(model, params, sched, device="cpu")
    assert runner.jit_groups and not runner.donate
    images = [torch.from_numpy(x) for x in _images(5, 2)]
    got = runner.run_pipelined(images)
    for jit, donate in ((False, None), (True, True)):
        other = DualCoreRunner(model, params, sched, device="cpu",
                               jit_groups=jit, donate=donate)
        for a, b in zip(other.run_pipelined(images), got):
            assert torch.equal(a, b)
    assert runner.lanes.count == 0
    ref_runner = RefRunner(model, _jnp(ref["params"]), ref_sched,
                           use_pallas=False, jit_groups=True)
    want = ref_runner.run_sequential([jnp.asarray(x.numpy())
                                      for x in images])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def _lane(key):
    shape, dtype = key
    return Lane(key=key, x=torch.zeros(shape, dtype=dtype), graphs=[],
                envs=[])


def test_lane_pool_grows_retires_and_reuses_in_order():
    """One lane per shape and dtype until every lane of the key is held,
    then the pool grows; a retired lane is handed out again, the one
    retired longest ago first, carrying the event its next user waits on
    on the card."""
    pool = LanePool(_lane)
    k1 = ((2, 8, 8, 3), torch.float32)
    k2 = ((1, 8, 8, 3), torch.float32)
    k3 = ((2, 8, 8, 3), torch.float64)
    a = pool.acquire(k1)
    b = pool.acquire(k1)                 # a is held: the pool grows
    c, d = pool.acquire(k2), pool.acquire(k3)
    assert b is not a and pool.count == 4
    assert pool.lanes == {k1: [a, b], k2: [c], k3: [d]}
    pool.retire(b, "event b")
    pool.retire(a, None)
    assert pool.acquire(k1) is b and b.free_after == "event b"
    assert pool.acquire(k1) is a and pool.count == 4
    e = pool.acquire(k1)                 # both held again: grows
    assert pool.lanes[k1] == [a, b, e] and e is not a and e is not b
    pool.retire(c, "event c")
    assert pool.acquire(k2) is c and pool.count == 5


def test_lane_load_never_writes_the_callers_input():
    """Group 0's env is the lane's own input buffer, a copy of the
    caller's tensor: what the graphs write lands in the lane."""
    lane = _lane(((2, 4, 4, 3), torch.float32))
    x = torch.from_numpy(_images(6, 1, size=4)[0])
    keep = x.clone()
    env = lane.load(x)
    assert env["h"] is lane.x and env["h"].data_ptr() != x.data_ptr()
    assert torch.equal(lane.x, x)
    env["h"].zero_()
    assert torch.equal(x, keep)


def test_engine_dispatch_trace_matches_reference_squeezenet(reference):
    """Same arrivals, same queue bound: the port's engine dispatches the
    same (slot, request, group, core) sequence as the reference's, and its
    outputs agree with the reference engine's."""
    ref = reference["squeezenet"]
    ref_sched, port_sched = _schedules("squeezenet", "balanced")
    ref_runner = RefRunner("squeezenet", _jnp(ref["params"]), ref_sched,
                           use_pallas=False, fuse=False, jit_groups=False)
    runner = DualCoreRunner("squeezenet",
                            params_from_numpy(ref["params"], "cpu"),
                            port_sched, device="cpu")
    assert len(runner.groups) == len(ref_runner.groups) == 3
    images = _images(11, 6)
    arrivals = [0, 0, 0, 1, 5, 5]
    ref_rec, rec = [], []
    ref_res = ref_replay(RefEngine(ref_runner, max_queue=2, record=ref_rec),
                         [RefRequest(jnp.asarray(x)) for x in images],
                         arrivals)
    res = replay(DualCoreEngine(runner, max_queue=2, record=rec),
                 [Request(torch.from_numpy(x)) for x in images], arrivals)
    assert rec == ref_rec
    assert res.stats["slots"] == ref_res.stats["slots"]
    assert res.metrics.completed == 6
    for a, b in zip(res.outputs, ref_res.outputs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_serving_api_matches_reference():
    assert poisson_arrivals(16, rate=0.7, seed=3) == \
        ref_poisson_arrivals(16, rate=0.7, seed=3)
    xs = [3.0, 1.0, 4.0, 1.5, 9.0]
    for q in (0, 50, 95, 100):
        assert percentile(xs, q) == ref_percentile(xs, q)
    assert GreedyAdmission().admit(queued=5, in_flight=2, capacity=4) == 2
    assert GreedyAdmission().admit(queued=1, in_flight=4, capacity=4) == 0
    assert FixedRateAdmission().admit(queued=5, in_flight=0, capacity=4) == 1
    with pytest.raises(ValueError, match="max_queue"):
        EngineBase(max_queue=0)
    with pytest.raises(ValueError, match="rate"):
        poisson_arrivals(4, rate=0.0)


def test_serve_cli_on_cpu(capsys):
    from repro_torch.launch.serve import main

    assert main(["cnn", "squeezenet", "--device", "cpu", "--image-size",
                 "32", "--requests", "3", "--batch", "1",
                 "--arrival-rate", "1.0"]) == 0
    out = capsys.readouterr().out
    assert "3 exec groups" in out and "T_b2=" in out and "(sim " in out
    assert "streamed 3 request(s)" in out and "p95" in out
    assert "alias one cpu queue" in out
