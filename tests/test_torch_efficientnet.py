"""EfficientNet in the port, on the CPU: the B4 graph at its published
widths, a small sibling's forward against the plain reference
(``models/efficientnet_ref.py``) and through the pipelined runner, the SE
gate's plain op, the new activations, the fusion plan, and the SE gates'
gauge.  The CUDA kernels are held on the card in
``tests/test_torch_cuda.py``."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.core.arch import DUAL_BASELINE, BoardModel
from repro_torch.core.fusion import fused_layer_counts, plan_fusion
from repro_torch.core.scheduler import build_schedule
from repro_torch.dualcore.program import build_program, effnet_act
from repro_torch.dualcore.runtime import DualCoreRunner
from repro_torch.kernels.conv_gemm.kernel import (conv2d_implicit_gemm,
                                                  matmul_bias_act)
from repro_torch.kernels.depthwise.kernel import depthwise_conv2d
from repro_torch.kernels.se.ops import squeeze_excite, squeeze_excite_ref
from repro_torch.kernels.se.kernel import (se_cluster, se_gate, se_scale,
                                           se_smem_floats)
from repro_torch.kernels.util import ACT_CODES, apply_act, launch_counts
from repro_torch.models.cnn import (FORWARDS, init_params, params_from_numpy)
from repro_torch.models.efficientnet_ref import efficientnet_forward_ref
from repro_torch.models.zoo import (PAPER_WORKLOADS, ZOO, efficientnet_graph,
                                    efficientnet_stages, get_graph)
from repro_torch.obs import Registry, SpanRecorder
from repro_torch.serving.api import Request, replay
from repro_torch.serving.cnn import DualCoreEngine

#: the small sibling: B0 at width 0.25, depth 0.5, 64 px (10 blocks, three
#: of them residual, the first a t = 1 block that adds its input)
SMALL = (0.25, 0.5, 64)


def _small_graph():
    return efficientnet_graph(*SMALL, name="efficientnet_small")


def _params(graph, seed):
    """He-init weights with biases of 0.1 (so the bias path is compared)."""
    params = init_params(graph, seed)
    rng = np.random.default_rng(seed + 1)
    for p in params.values():
        p["b"] = (0.1 * rng.standard_normal(p["b"].shape)).astype(np.float32)
    return params_from_numpy(params, "cpu")


def _images(n, px, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((2, px, px, 3), generator=g) for _ in range(n)]


# --------------------------------------------------------------------------
# (a) the B4 graph at its published widths
# --------------------------------------------------------------------------
def test_b4_graph_has_the_published_shapes():
    g = get_graph("efficientnet_b4")
    assert efficientnet_stages(1.4, 1.8) == [
        (1, 3, 1, 24, 2), (6, 3, 2, 32, 4), (6, 5, 2, 56, 4),
        (6, 3, 2, 112, 6), (6, 5, 1, 160, 6), (6, 5, 2, 272, 8),
        (6, 3, 1, 448, 2)]
    dws = [l for l in g.layers if l.op == "dwconv"]
    assert len(dws) == 32
    assert sum("add" in l.fused for l in g.layers) == 25
    assert g.layer("stem").C_o == 48 and g.layer("stem").H_out == 190
    assert g.layer("conv_last").C_o == 1792
    assert (g.layer("conv_last").H, g.layer("conv_last").W) == (12, 12)
    assert (g.layer("fc").C_i, g.layer("fc").C_o) == (1792, 1000)
    outs = [g.layer(f"b{i}_project").C_o for i in range(1, 33)]
    assert sorted(set(outs)) == [24, 32, 56, 112, 160, 272, 448]
    assert sorted({l.H_out for l in dws}) == [12, 24, 48, 95, 190]
    se = [l for l in g.layers if "_se_" in l.name]
    assert len(se) == 64 and all(l.op == "fc" and l.H == 1 for l in se)
    # the SE gate: max(1, block input // 4) channels
    assert g.layer("b1_se_reduce").C_o == 12      # block input 48
    assert g.layer("b32_se_reduce").C_o == 112    # block input 448
    # 4.391 G multiply-adds in the convs and the classifier, 3.1 M in the
    # SE FCs; 19.28 M weights and biases
    se_macs = sum(l.macs for l in se)
    assert round((g.total_macs - se_macs) / 1e9, 3) == 4.391
    assert round(g.total_macs / 1e9, 3) == 4.394
    assert round(g.total_params / 1e6, 2) == 19.28
    # the 5x5 depthwise convs of stages 3, 5 and 6 hold 64% of the
    # depthwise multiply-adds
    dw5 = sum(l.macs for l in dws if l.K_h == 5)
    assert round(dw5 / sum(l.macs for l in dws), 2) == 0.64
    assert all(l.pad == l.K_h // 2 for l in g.layers if l.K_h > 1)


def test_get_graph_resolves_b4_and_the_paper_keeps_its_three():
    assert set(PAPER_WORKLOADS) == {"mobilenet_v1", "mobilenet_v2",
                                    "squeezenet"}
    assert set(ZOO) == set(PAPER_WORKLOADS) | {"efficientnet_b4"}
    assert get_graph("efficientnet_b4").name == "efficientnet_b4"
    assert "efficientnet_b4" in FORWARDS
    with pytest.raises(KeyError, match="efficientnet_b4"):
        get_graph("efficientnet_b7")


def test_b4_balanced_plan_has_29_groups_and_32_se_steps():
    g = get_graph("efficientnet_b4")
    runner = DualCoreRunner("efficientnet_b4",
                            params_from_numpy(init_params(g, 0), "cpu"),
                            build_schedule(g, DUAL_BASELINE, BoardModel(),
                                           "balanced"), device="cpu")
    assert len(runner.groups) == 29
    assert "".join(x.core for x in runner.groups) == "cp" * 14 + "c"
    steps = [s for x in runner.groups for s in x.steps]
    assert [s.layers for s in steps if s.name.endswith("_se")] == [
        (f"b{i}_se_reduce", f"b{i}_se_expand") for i in range(1, 33)]
    eng = DualCoreEngine(runner, obs=Registry())
    gauge = eng.snapshot()["gauges"]["runner_se_gates"]["series"]
    assert sum(gauge.values()) == 32
    assert set(gauge) == {"core=c", "core=p"} and min(gauge.values()) > 0


# --------------------------------------------------------------------------
# (b) a small sibling: the reference, the sequential and pipelined forwards
# --------------------------------------------------------------------------
def test_small_sibling_matches_the_plain_reference():
    """The port's sequential forward (im2col GEMMs, the depthwise taps in
    order, the SE op) against ``F.conv2d`` and matmuls in float32: only
    the summation order differs, about 1e-7 relative an operation, which
    twenty-odd layers grow to about 1e-6 of the logits' RMS.  1e-4 leaves
    that room and still fails a missing or misplaced operation (a skipped
    gate or residual moves the logits by tenths of their RMS)."""
    g = _small_graph()
    for seed in (1, 2):
        params = _params(g, seed)
        x = _images(1, SMALL[2], seed)[0]
        out = build_program(g).run(params, x)
        ref = efficientnet_forward_ref(params, x, *SMALL[:2])
        assert out.shape == ref.shape == (2, 1000)
        rms = ref.pow(2).mean().sqrt()
        assert float((out - ref).abs().max() / rms) < 1e-4


def test_small_sibling_reference_sees_a_skipped_gate(monkeypatch):
    g = _small_graph()
    params = _params(g, 3)
    x = _images(1, SMALL[2], 3)[0]
    ref = efficientnet_forward_ref(params, x, *SMALL[:2])
    import repro_torch.kernels.se.ops as se_ops
    monkeypatch.setattr(se_ops, "se_scale", lambda h, gate: h)
    out = build_program(g).run(params, x)
    assert float((out - ref).abs().max() / ref.pow(2).mean().sqrt()) > 1e-2


def test_small_sibling_pipelined_equals_sequential_bit_for_bit():
    g = _small_graph()
    params = _params(g, 4)
    images = _images(4, SMALL[2], 4)
    runner = DualCoreRunner(g, params, build_schedule(
        g, DUAL_BASELINE, BoardModel(), "balanced"), device="cpu")
    assert len(runner.groups) > 2
    want = [build_program(g).run(params, x) for x in images]
    got = runner.run_pipelined(images)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_residual_stash_lands_on_the_first_layer_of_each_block():
    """The t = 1 block stashes at its depthwise conv, the others at their
    expansion; a projection reads the stash only where it adds it."""
    prog = build_program(_small_graph())
    steps = {s.name: s for s in prog.steps}
    assert steps["b1_dw"].writes == ("h", "res")       # t = 1, residual
    assert steps["b2_expand"].writes == ("h", "res")
    assert steps["b1_project"].reads == ("h", "res")
    assert steps["b2_project"].reads == ("h",)         # stride 2
    assert [s.name for s in prog.steps][:5] == [
        "stem", "b1_dw", "b1_se", "b1_project", "b2_expand"]


# --------------------------------------------------------------------------
# (c) the SE op and the new activations
# --------------------------------------------------------------------------
def _se_case(n=2, h=7, c=24, s=6, seed=5):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, h, h, c), generator=g)
    w1 = torch.randn((c, s), generator=g) * (2 / c) ** 0.5
    b1 = torch.randn((s,), generator=g) * 0.1
    w2 = torch.randn((s, c), generator=g) * (2 / s) ** 0.5
    b2 = torch.randn((c,), generator=g) * 0.1
    return x, w1, b1, w2, b2


def test_se_plain_op_matches_the_gate_in_torch():
    x, w1, b1, w2, b2 = _se_case()
    pooled = F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2), 1).flatten(1)
    gate = torch.sigmoid(F.linear(F.silu(F.linear(pooled, w1.T, b1)),
                                  w2.T, b2))
    want = x * gate[:, None, None, :]
    got = squeeze_excite(x, w1, b1, w2, b2)          # CPU: the plain path
    torch.testing.assert_close(se_gate(x, w1, b1, w2, b2), gate)
    torch.testing.assert_close(got, want)
    assert torch.equal(got, squeeze_excite_ref(x, w1, b1, w2, b2))
    assert torch.equal(se_scale(x, gate), x * gate[:, None, None, :])


def test_se_wrappers_refuse_bad_shapes_and_count_nothing_on_cpu():
    x, w1, b1, w2, b2 = _se_case()
    before = launch_counts()
    with pytest.raises(ValueError):
        se_gate(x, w1, b1, w2.T.contiguous(), b2)
    with pytest.raises(ValueError):
        se_gate(x, w1, b2, w2, b2)
    with pytest.raises(ValueError):
        se_scale(x, torch.ones(2, 5))
    se_gate(x, w1, b1, w2, b2)
    assert launch_counts() == before
    assert {"se_gate", "se_scale"} <= set(before)


@pytest.mark.parametrize("hw,c,cl", [(190 * 190, 48, 8), (12 * 12, 2688, 6),
                                     (24 * 24, 672, 6), (4, 8, 1)])
def test_se_cluster_and_shared_memory(hw, c, cl):
    assert se_cluster(hw, c) == cl
    assert 4 * se_smem_floats(c, max(1, c // 24)) <= 48 * 1024


def test_silu_and_sigmoid_in_apply_act_match_torch():
    x = torch.linspace(-30, 30, 2001)
    torch.testing.assert_close(apply_act(x, "silu"), x * torch.sigmoid(x))
    torch.testing.assert_close(apply_act(x, "sigmoid"),
                               1 / (1 + torch.exp(-x)))
    assert (ACT_CODES["silu"], ACT_CODES["sigmoid"]) == (3, 4)
    assert [effnet_act(n) for n in ("stem", "b3_expand", "b3_dw",
                                    "b3_se_reduce", "b3_se_expand",
                                    "b3_project", "conv_last", "fc")] == [
        "silu", "silu", "silu", "silu", "sigmoid", None, "silu", None]


@pytest.mark.parametrize("act", ["silu", "sigmoid"])
def test_k1_k2_k3_plain_versions_take_the_new_activations(act):
    g = torch.Generator().manual_seed(6)
    x = torch.randn((2, 9, 9, 8), generator=g)
    w = torch.randn((8, 12), generator=g)
    b = torch.randn((12,), generator=g)
    torch.testing.assert_close(
        matmul_bias_act(x.reshape(-1, 8), w, b, act=act),
        apply_act(x.reshape(-1, 8) @ w + b, act))
    dw = torch.randn((5, 5, 8), generator=g)
    want = F.conv2d(x.permute(0, 3, 1, 2), dw.permute(2, 0, 1).unsqueeze(1),
                    b[:8], stride=2, padding=2, groups=8)
    torch.testing.assert_close(
        depthwise_conv2d(x, dw, b[:8], stride=2, pad=2, act=act),
        apply_act(want, act).permute(0, 2, 3, 1), rtol=1e-5, atol=1e-5)
    w3 = torch.randn((3, 3, 8, 12), generator=g)
    want = F.conv2d(x.permute(0, 3, 1, 2), w3.permute(3, 2, 0, 1), b,
                    stride=2, padding=1)
    torch.testing.assert_close(
        conv2d_implicit_gemm(x, w3, b, stride=2, pad=1, act=act),
        apply_act(want, act).permute(0, 2, 3, 1), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# (d) no fusion crosses an SE block
# --------------------------------------------------------------------------
@pytest.mark.parametrize("graph", [get_graph("efficientnet_b4"),
                                   _small_graph()],
                         ids=["b4", "small"])
def test_plan_fusion_leaves_every_se_block_unfused(graph):
    assert fused_layer_counts(graph) == {"single": len(graph)}
    assert all(len(grp.layers) == 1 for grp in plan_fusion(graph))
    runner = DualCoreRunner(graph, _params(graph, 0), build_schedule(
        graph, DUAL_BASELINE, BoardModel(), "balanced"), device="cpu")
    steps = [s for x in runner.groups for s in x.steps]
    assert not any("+" in s.name for s in steps)     # no fused launch
    assert len(steps) == len(graph) - sum(
        l.name.endswith("_se_expand") for l in graph.layers)


# --------------------------------------------------------------------------
# tracing: the SE gates in the registry
# --------------------------------------------------------------------------
def test_se_gauge_counts_each_cores_se_gates():
    """``runner_se_gates``: each core's SE gates, read from its exec
    groups' layers; the group spans carry no model-specific field."""
    g = _small_graph()
    runner = DualCoreRunner(g, _params(g, 7), build_schedule(
        g, DUAL_BASELINE, BoardModel(), "balanced"), device="cpu")
    spans = SpanRecorder(enabled=True)
    eng = DualCoreEngine(runner, obs=Registry(), spans=spans)
    replay(eng, [Request(x) for x in _images(2, SMALL[2], 7)], [0, 0])
    groups = [s for s in spans.drain() if s.name == "runner.group"]
    assert len(groups) == 2 * len(runner.groups)
    gauge = eng.snapshot()["gauges"]["runner_se_gates"]["series"]
    want = {f"core={c}": sum(n.endswith("_se_reduce") for x in runner.groups
                             if x.core == c for n in x.layers) for c in "cp"}
    assert gauge == want and sum(gauge.values()) == 10


def test_a_model_without_se_gates_sets_no_gauge():
    g = get_graph("mobilenet_v1")
    runner = DualCoreRunner("mobilenet_v1", _params(g, 0), build_schedule(
        g, DUAL_BASELINE, BoardModel(), "balanced"), device="cpu")
    eng = DualCoreEngine(runner, obs=Registry())
    assert "runner_se_gates" not in eng.snapshot()["gauges"]


@pytest.mark.parametrize("act", ["silu", "sigmoid"])
def test_fused_blocks_refuse_the_new_activations(act):
    """K4 and K5 are compiled for none, relu and relu6 alone: asked for
    silu or sigmoid they raise, on the CPU as on the card."""
    from repro_torch.kernels.fused_block.kernel import (fused_dw_pw_conv,
                                                        fused_pw_dw_pw_conv)

    x = torch.zeros((1, 5, 5, 8))
    dw, b8 = torch.zeros((3, 3, 8)), torch.zeros(8)
    pw = torch.zeros((8, 8))
    with pytest.raises(ValueError, match="K4 and K5"):
        fused_dw_pw_conv(x, dw, b8, pw, b8, dw_act=act)
    with pytest.raises(ValueError, match="K4 and K5"):
        fused_pw_dw_pw_conv(x, pw, b8, dw, b8, pw, b8, proj_act=act)
    fused_dw_pw_conv(x, dw, b8, pw, b8, dw_act="relu6")
