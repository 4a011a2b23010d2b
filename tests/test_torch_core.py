"""The port's copies of the scheduling core agree with the reference: for
every zoo model and scheme, the same alternating groups (cores, layer
specs) and the same two-batch latency T_b2; the same fusion plan; the same
instruction streams and the same simulated cycles."""
import pytest

from repro.core.arch import DUAL_BASELINE as REF_DUAL, BoardModel as RefBoard
from repro.core.fusion import plan_fusion as ref_plan_fusion
from repro.core.isa import compile_schedule as ref_compile_schedule
from repro.core.scheduler import build_schedule as ref_build_schedule
from repro.core.simulator import simulate_dual_core as ref_simulate_dual_core
from repro.core.simulator import (
    simulate_single_core as ref_simulate_single_core)
from repro.dualcore.program import build_program as ref_build_program
from repro.dualcore.runtime import build_exec_plan as ref_build_exec_plan
from repro.models.zoo import get_graph as ref_get_graph
from repro_torch.core.arch import DUAL_BASELINE, BoardModel
from repro_torch.core.fusion import plan_fusion
from repro_torch.core.isa import compile_schedule
from repro_torch.core.scheduler import best_schedule, build_schedule
from repro_torch.core.simulator import (simulate_dual_core,
                                        simulate_single_core)
from repro_torch.dualcore.program import build_program
from repro_torch.dualcore.runtime import build_exec_plan
from repro_torch.models.zoo import get_graph

MODELS = ("mobilenet_v1", "mobilenet_v2", "squeezenet")
SCHEMES = ("layer_type", "greedy", "round_robin", "balanced")


def _groups(sched):
    return [(g.core, [tuple(vars(l).items()) for l in g.layers])
            for g in sched.groups]


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("model", MODELS)
def test_schedule_matches_reference(model, scheme):
    ref = ref_build_schedule(ref_get_graph(model), REF_DUAL, RefBoard(),
                             scheme)
    port = build_schedule(get_graph(model), DUAL_BASELINE, BoardModel(),
                          scheme)
    assert _groups(port) == _groups(ref)
    assert port.group_latencies == ref.group_latencies
    assert port.t_b2() == ref.t_b2()
    assert port.validate_alternating()


@pytest.mark.parametrize("model", MODELS)
def test_fusion_plan_matches_reference(model):
    ref = [(g.kind, g.layers) for g in ref_plan_fusion(ref_get_graph(model))]
    port = [(g.kind, g.layers) for g in plan_fusion(get_graph(model))]
    assert port == ref


def test_best_schedule_matches_reference():
    from repro.core.scheduler import best_schedule as ref_best
    ref = ref_best(ref_get_graph("squeezenet"), REF_DUAL, RefBoard())
    port = best_schedule(get_graph("squeezenet"), DUAL_BASELINE,
                         BoardModel())
    assert port.scheme == ref.scheme
    assert port.t_b2() == ref.t_b2()
    assert _groups(port) == _groups(ref)


def _exec_schedules(model, scheme):
    """The reference's and the port's exec schedules (the merged chain the
    runtime executes under ``fuse="group"``), from which the CLIs
    simulate."""
    ref = ref_build_exec_plan(
        ref_build_program(model, use_pallas=True, fuse=False),
        ref_build_schedule(ref_get_graph(model), REF_DUAL, RefBoard(),
                           scheme), group_fusion=True).exec_schedule
    port = build_exec_plan(
        build_program(model, fuse=False),
        build_schedule(get_graph(model), DUAL_BASELINE, BoardModel(),
                       scheme), group_fusion=True).exec_schedule
    return ref, port


def _streams(streams):
    return [[(i.op, i.layer, i.cycles, i.bank, i.meta) for i in s]
            for s in streams]


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("model", MODELS)
def test_simulator_matches_reference(model, scheme):
    ref, port = _exec_schedules(model, scheme)
    assert _streams(compile_schedule(port)) == \
        _streams(ref_compile_schedule(ref))
    a, b = simulate_dual_core(port), ref_simulate_dual_core(ref)
    assert a.cycles_two_images == b.cycles_two_images
    assert a.slot_latencies == b.slot_latencies
    assert a.fps == b.fps
    assert a.pe_efficiency == b.pe_efficiency


@pytest.mark.parametrize("model", MODELS)
def test_single_core_simulation_matches_reference(model):
    a = simulate_single_core(get_graph(model), DUAL_BASELINE.c, BoardModel())
    b = simulate_single_core(ref_get_graph(model), REF_DUAL.c, RefBoard())
    assert (a.cycles, a.instr_count, a.busy_cycles, a.per_layer) == \
        (b.cycles, b.instr_count, b.busy_cycles, b.per_layer)
