"""The port's copies of the scheduling core agree with the reference: for
every zoo model and scheme, the same alternating groups (cores, layer
specs) and the same two-batch latency T_b2; the same fusion plan."""
import pytest

from repro.core.arch import DUAL_BASELINE as REF_DUAL, BoardModel as RefBoard
from repro.core.fusion import plan_fusion as ref_plan_fusion
from repro.core.scheduler import build_schedule as ref_build_schedule
from repro.models.zoo import get_graph as ref_get_graph
from repro_torch.core.arch import DUAL_BASELINE, BoardModel
from repro_torch.core.fusion import plan_fusion
from repro_torch.core.scheduler import best_schedule, build_schedule
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
