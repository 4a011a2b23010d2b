"""The CUDA kernels, the dual-core runtime and its graphs on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA card (the
``card`` fixture decides, when the test runs).  On a machine with a card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

The file imports neither JAX nor the reference package.  TF32 is off, so the
kernels and their plain versions are both full f32 and agree at rtol = atol
= 1e-4 (only the summation order differs).
"""
import ctypes
import dataclasses
import json
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.arch import DUAL_BASELINE, BoardModel
from repro_torch.core.scheduler import build_schedule
from repro_torch.dualcore.program import build_program
from repro_torch.dualcore.runtime import (DualCoreRunner, DualCores,
                                          wait_ready)
from repro_torch.kernels.conv_gemm.kernel import (conv2d_implicit_gemm,
                                                  matmul_bias_act)
from repro_torch.kernels.depthwise.kernel import depthwise_conv2d
from repro_torch.kernels.fused_block.kernel import (fused_dw_pw_conv,
                                                    fused_pw_dw_pw_conv)
from repro_torch.configs.registry import get_smoke
from repro_torch.dualmesh.partition import split_streams
from repro_torch.dualmesh.runtime import DualMeshRunner, random_prompts
from repro_torch.fleet import (DevicePool, Rebalance, build_cnn_fleet,
                               make_policy)
from repro_torch.kernels.attention.kernel import (decode_attention,
                                                  flash_attention)
from repro_torch.kernels import green
from repro_torch.kernels.rmsnorm.kernel import rmsnorm
from repro_torch.kernels.util import resolve_device
from repro_torch.lm.model import forward, init_params, params_from_numpy
from repro_torch.models.cnn import build_model
from repro_torch.obs import Registry, SpanRecorder, readings
from repro_torch.serving.api import Request
from repro_torch.serving.cnn import DualCoreEngine, stream_images

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
WRAPPERS = {"K1": matmul_bias_act, "K2": depthwise_conv2d,
            "K3": conv2d_implicit_gemm, "K4": fused_dw_pw_conv,
            "K5": fused_pw_dw_pw_conv}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: python -m pytest -m cuda "
                    "tests/test_torch_cuda.py on a machine with one")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _arrays(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.standard_normal(s) * scale)
                             .astype(np.float32)) for s in shapes]


def _case(kernel):
    if kernel == "K1":
        x, w, b = _arrays(5, (300, 70), (70, 130), (130,))
        return (x, w, b), dict(act="relu6")
    if kernel == "K2":
        x, w, b = _arrays(5, (2, 30, 29, 70), (3, 3, 70), (70,))
        return (x, w, b), dict(stride=2, pad=1, act="relu")
    if kernel == "K3":
        x, w, b = _arrays(5, (2, 33, 31, 3), (3, 3, 3, 40), (40,))
        return (x, w, b), dict(stride=2, pad=1, act="relu6")
    if kernel == "K4":
        x, dw, db, pw, pb, r = _arrays(5, (2, 15, 15, 40), (3, 3, 40),
                                       (40,), (40, 70), (70,),
                                       (2, 15, 15, 70), scale=0.5)
        return (x, dw, db, pw, pb, r), dict(stride=1, pad=1, dw_act="relu6",
                                            pw_act=None)
    # K5: a residual, nonzero biases (the expand bias positive, so a halo
    # padded with act(exp_b) instead of 0 would show), ragged Cm and Co
    x, ew, eb, dw, db, pw, pb, r = _arrays(
        5, (2, 15, 13, 24), (24, 70), (70,), (3, 3, 70), (70,), (70, 24),
        (24,), (2, 15, 13, 24), scale=0.5)
    return (x, ew, eb.abs() + 0.5, dw, db, pw, pb, r), dict(
        stride=1, pad=1, exp_act="relu6", dw_act="relu6", proj_act=None)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(WRAPPERS))
def test_kernel_matches_plain_on_card(kernel, card):
    fn = WRAPPERS[kernel]
    args, kw = _case(kernel)
    before = fn.launches
    got = fn(*(a.to(card) for a in args), **kw)
    want = fn(*args, **kw)                   # CPU tensors: the plain version
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **TOL)


def _fused_calls():
    """Every distinct K4 and K5 call of the CNN paths (batch 2, 224 px)
    and ``chip_smoke.py``'s K4/K5 edge cases."""
    seen = {}
    for c in [*chip_smoke.cnn_path_calls(), *chip_smoke.edge_calls()]:
        if c["kernel"] in chip_smoke.FUSED_KERNELS:
            seen.setdefault(json.dumps(c, sort_keys=True), c)
    return list(seen.values())


FUSED_CALLS = _fused_calls()


@pytest.mark.cuda
@pytest.mark.parametrize("call", FUSED_CALLS,
                         ids=[chip_smoke._shape_str(c).replace(" ", ",")
                              + f"-{c['kernel'][6:]}" for c in FUSED_CALLS])
def test_fused_kernel_matches_plain_at_path_shape_on_card(call, card):
    """K4 and K5 at every path shape and edge case, each with the tiling
    its planner gives, against the plain version at 1e-4."""
    fn = WRAPPERS["K4" if call["kernel"] == "fused_dw_pw_conv" else "K5"]
    case = chip_smoke.make_case(call, np.random.default_rng(11))
    before = fn.launches
    got = case["kernel"]()
    want = case["plain"]()
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)


def _k1k2_calls():
    """Every distinct K1 and K2 call of the CNN paths (batch 2, 224 px)
    and ``chip_smoke.py``'s K1/K2 edge cases: the M = 2 heads, a ragged K of
    13 and of 1283, ragged N, stride 2, a ragged C, a 5x5 window."""
    seen = {}
    for c in [*chip_smoke.cnn_path_calls(), *chip_smoke.edge_calls()]:
        if c["kernel"] in ("matmul_bias_act", "depthwise_conv2d"):
            seen.setdefault(json.dumps(c, sort_keys=True), c)
    return list(seen.values())


K1K2_CALLS = _k1k2_calls()


@pytest.mark.cuda
@pytest.mark.parametrize("call", K1K2_CALLS,
                         ids=[chip_smoke._shape_str(c).replace(" ", ",")
                              + f"-{c['kernel'][:6]}" for c in K1K2_CALLS])
def test_k1_k2_match_plain_at_path_shape_on_card(call, card):
    """K1 and K2 at every path shape and edge case, each with the tiling
    its planner gives, against the plain version at 1e-4; a repeated call
    gives the same bits."""
    fn = WRAPPERS["K1" if call["kernel"] == "matmul_bias_act" else "K2"]
    case = chip_smoke.make_case(call, np.random.default_rng(13))
    before = fn.launches
    got = case["kernel"]()
    again = case["kernel"]()
    want = case["plain"]()
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("call", [
    dict(kernel="matmul_bias_act", m=2, k=1280, n=1000, act=None),
    dict(kernel="matmul_bias_act", m=98, k=1024, n=1024, act="relu6"),
    dict(kernel="depthwise_conv2d", n=2, h=112, w=112, c=96, k=3, stride=2,
         pad=1, act="relu6")], ids=["K1-head", "K1-v1", "K2"])
def test_k1_k2_same_bits_on_two_streams_on_card(call, card):
    """Two launches on two streams give the bits of the first on the
    current stream: K1's ranks meet in rank order (clusters of 14-16 at
    these shapes), K2 sums its taps in a fixed order."""
    case = chip_smoke.make_case(call, np.random.default_rng(14))
    first = case["kernel"]()
    outs = []
    for stream in (torch.cuda.Stream(), torch.cuda.Stream()):
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            outs.append(case["kernel"]())
    torch.cuda.synchronize()
    assert all(torch.equal(first, o) for o in outs)


@pytest.mark.cuda
@pytest.mark.parametrize("call", [
    dict(kernel="fused_dw_pw_conv", n=2, h=7, w=7, c=960, co=320, k=3,
         stride=1, pad=1, dw_act="relu6", pw_act=None, res=False),
    dict(kernel="fused_pw_dw_pw_conv", n=2, h=14, w=14, ci=512, cm=512,
         co=1024, k=3, stride=2, pad=1, exp_act="relu6", dw_act="relu6",
         proj_act="relu6", res=False)], ids=["K4", "K5"])
def test_fused_kernel_same_bits_on_two_streams_on_card(call, card):
    """Two launches on two streams, each reducing over a cluster of 15-16
    blocks, give the same bits: the partial sums meet in rank order."""
    case = chip_smoke.make_case(call, np.random.default_rng(12))
    first = case["kernel"]()
    outs = []
    for stream in (torch.cuda.Stream(), torch.cuda.Stream()):
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            outs.append(case["kernel"]())
    torch.cuda.synchronize()
    assert all(torch.equal(first, o) for o in outs)


def _k3_calls():
    """Every distinct K3 call of the CNN paths (batch 2, 224 px: the stems
    at Ci = 3, SqueezeNet's e3x3 at 56^2 to 14^2) and ``chip_smoke.py``'s
    K3 edge cases (no bias, Ci = 5 at stride 2 and no pad), plus a ragged
    Co and a pixel count that is no multiple of any tile."""
    seen = {}
    for c in [*chip_smoke.cnn_path_calls(), *chip_smoke.edge_calls(),
              dict(kernel="conv2d_implicit_gemm", n=1, h=9, w=7, ci=12,
                   co=37, k=3, stride=1, pad=1, act="relu6"),
              dict(kernel="conv2d_implicit_gemm", n=2, h=14, w=14, ci=64,
                   co=250, k=5, stride=1, pad=2, act=None)]:
        if c["kernel"] == "conv2d_implicit_gemm":
            seen.setdefault(json.dumps(c, sort_keys=True), c)
    return list(seen.values())


K3_CALLS = _k3_calls()


def _on_two_streams(case):
    """The kernel's output on the current stream, then on two others."""
    first = case["kernel"]()
    outs = []
    for stream in (torch.cuda.Stream(), torch.cuda.Stream()):
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            outs.append(case["kernel"]())
    torch.cuda.synchronize()
    return first, outs


@pytest.mark.cuda
@pytest.mark.parametrize("call", K3_CALLS,
                         ids=[chip_smoke._shape_str(c).replace(" ", ",")
                              for c in K3_CALLS])
def test_k3_matches_plain_at_path_shape_on_card(call, card):
    """K3 at every path shape and edge case, with the tiling ``plan_k3``
    gives: one launch a call, within 1e-4 of the plain version, and the
    same bits on two other streams (the cluster's ranks meet in rank
    order)."""
    fn = WRAPPERS["K3"]
    case = chip_smoke.make_case(call, np.random.default_rng(15))
    before = fn.launches
    got = case["kernel"]()
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = case["plain"]()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)
    first, outs = _on_two_streams(case)
    assert torch.equal(first, got) and all(torch.equal(got, o)
                                           for o in outs)


# K7 decode's (G, D): Qwen2-0.5B, Qwen2.5-14B, Command R+ and Granite-20B
DECODE_GEOMETRIES = [(7, 64), (5, 128), (12, 128), (48, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("g,d", DECODE_GEOMETRIES,
                         ids=[f"G{g}-D{d}" for g, d in DECODE_GEOMETRIES])
@pytest.mark.parametrize("lens", [None, [576, 0, 1, 300]],
                         ids=["full", "ragged"])
def test_k7_decode_geometries_on_card(g, d, lens, card):
    """K7 decode at the registered dense configs' head geometry (2 kv
    heads, a cache of 576 cut from 600), whole or ragged down to
    ``kv_len`` 0 and 1: one launch a call, within 1e-4 of the plain
    version, the same bits on two other streams."""
    call = dict(kernel="decode_attention", b=4, hq=2 * g, hkv=2, sk=576,
                d=d, cap=600, kv_len=lens)
    case = chip_smoke.make_case(call, np.random.default_rng(16))
    before = decode_attention.launches
    got = case["kernel"]()
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    want = case["plain"]()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)
    if lens is not None:
        assert not got[1].any()                 # kv_len 0: written as 0
    first, outs = _on_two_streams(case)
    assert torch.equal(first, got) and all(torch.equal(got, o)
                                           for o in outs)


@pytest.mark.cuda
def test_wrappers_refuse_bad_operands_on_card(card):
    x, w = (t.to(card) for t in _arrays(6, (8, 4), (4, 8)))
    with pytest.raises(ValueError, match="contiguous"):
        matmul_bias_act(x, w.t().contiguous().t())
    with pytest.raises(TypeError, match="float32"):
        matmul_bias_act(x.double(), w.double())
    with pytest.raises(ValueError, match="is on"):
        matmul_bias_act(x, w.cpu())


def _kernel_of(step, graph):
    if len(step.layers) == 3:
        return fused_pw_dw_pw_conv
    if len(step.layers) == 2:
        return fused_dw_pw_conv
    l = graph.layer(step.layers[0])
    return (depthwise_conv2d if l.op == "dwconv"
            else conv2d_implicit_gemm if l.K_h > 1 else matmul_bias_act)


def _check_two_streams(model, card):
    params, _, graph = build_model(model, seed=1, device=card)
    sched = build_schedule(graph, DUAL_BASELINE, BoardModel(), "balanced")
    runner = DualCoreRunner(model, params, sched, device=card)
    assert runner.cores.distinct
    images = [t.to(card) for t in _arrays(7, *[(1, 64, 64, 3)] * 3)]
    seq = runner.run_sequential(images)
    per_image = Counter(_kernel_of(s, graph) for g in runner.groups
                        for s in g.steps)
    before = {fn: fn.launches for fn in WRAPPERS.values()}
    res = stream_images(runner, images)
    for fn in WRAPPERS.values():
        assert fn.launches - before[fn] == 3 * per_image[fn]
    plain = build_program(model, plain=True)
    for x, a, b in zip(images, res.outputs, seq):
        assert torch.equal(a, b)
        assert a.shape == (1, 1000) and torch.isfinite(a).all()
        torch.testing.assert_close(a, plain.run(params, x), rtol=1e-3,
                                   atol=1e-3)
    return per_image


@pytest.mark.cuda
def test_two_streams_pipelined_equals_sequential_on_card(card):
    """mobilenet_v2 ``balanced`` at 64 px: the engine over the two streams
    gives the sequential kernel forward's bits, launches exactly the plan's
    kernels per image, and agrees with the all-plain forward at 1e-3."""
    _check_two_streams("mobilenet_v2", card)


@pytest.mark.cuda
def test_two_streams_mobilenet_v1_on_card(card):
    """mobilenet_v1 ``balanced`` at 64 px, the same checks; its four
    pw->dw->pw chains run on K5."""
    per_image = _check_two_streams("mobilenet_v1", card)
    assert per_image[fused_pw_dw_pw_conv] == 4


@pytest.mark.cuda
@pytest.mark.parametrize("burst", [1, 4])
def test_fleet_two_models_equal_standalone_on_card(burst, card):
    """mobilenet_v1 + squeezenet as one fleet on one pool of the card's two
    cores (disjoint SMs) at 64 px (their groups interleave on the shared
    cores, four slots a member a step with ``burst=4``), a REBALANCE to
    0.7 with work in flight, which gives the c-core more SMs: every output
    bit-equal to its model's standalone engine, and the launches the
    plans' per-image counts."""
    models = ["mobilenet_v1", "squeezenet"]
    fleet, pool = build_cnn_fleet(models, device=card, seed=1, burst=burst,
                                  policy=make_policy("weighted_fair"))
    stats = pool.stats()
    assert pool.cores.distinct and stats["sm_split"] is True
    sms = stats["sms"]
    images = [t.to(card) for t in _arrays(9, *[(1, 64, 64, 3)] * 6)]
    tags = [models[i % 2] for i in range(6)]
    alone, per_image = {}, {}
    for m in models:
        params, _, graph = build_model(m, seed=1, device=card)
        sched = build_schedule(graph, DUAL_BASELINE, BoardModel(),
                               "balanced")
        runner = DualCoreRunner(m, params, sched, device=card)
        per_image[m] = Counter(_kernel_of(s, graph)
                               for g in runner.groups for s in g.steps)
        alone[m] = iter(stream_images(
            runner, [x for x, t in zip(images, tags) if t == m]).outputs)
    want = [next(alone[t]) for t in tags]
    for m in fleet.members:          # warm each member's graphs, as the CLI
        m.engine.runner.run_sequential(images[:1])
    before = {fn: fn.launches for fn in WRAPPERS.values()}
    for x, t in zip(images, tags):
        fleet.submit(Request(x, model=t))
    fleet.step()
    fleet.executor.inject(Rebalance(theta=0.7))
    res = fleet.drain()
    for fn in WRAPPERS.values():
        assert fn.launches - before[fn] == 3 * sum(
            per_image[m][fn] for m in models)
    # the pool keeps the theta asked; the cores the share realised
    assert pool.theta == pool.cores.asked == 0.7
    c, p = pool.cores.sms("c"), pool.cores.sms("p")
    assert pool.cores.theta == c / (c + p) and c > sms["c"]
    assert pool.stats()["sms"] == {"c": c, "p": p}
    assert [c.status for c in res.completions] == ["ok"] * 6
    for a, b in zip(res.outputs, want):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# the LM kernels and path
# --------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", [(1, 896), (16, 896), (1024, 896),
                                    (7, 257), (3, 2048)])
def test_k6_matches_plain_on_card(rows, d, card):
    x, w = _arrays(8, (rows, d), (d,))
    before = rmsnorm.launches
    got = rmsnorm(x.to(card), w.to(card))
    torch.cuda.synchronize()
    assert rmsnorm.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), rmsnorm(x, w).numpy(),
                               **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,q_offset,sk_valid,cap", [
    (1, 14, 2, 512, 512, 64, True, 0, None, 512),
    (2, 14, 2, 37, 37, 64, True, 0, None, 37),
    (2, 14, 2, 20, 50, 64, True, 30, None, 80),     # chunk against a cache
    (1, 6, 3, 40, 100, 64, False, 0, 71, 100),      # padding mask
    (2, 4, 2, 33, 33, 8, True, 0, None, 33),        # D = 8
])
def test_k7_flash_matches_plain_on_card(b, hq, hkv, sq, sk, d, causal,
                                        q_offset, sk_valid, cap, card):
    q, k, v = _arrays(9, (b, hq, sq, d), (b, hkv, cap, d), (b, hkv, cap, d),
                      scale=0.5)
    kw = dict(causal=causal, q_offset=q_offset, sk_valid=sk_valid)
    before = flash_attention.launches
    got = flash_attention(q.to(card), k.to(card)[:, :, :sk],
                          v.to(card)[:, :, :sk], **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention(q, k[:, :, :sk], v[:, :, :sk], **kw)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **TOL)


# K7 flash at the planner's edges: (b, hq, hkv, sq, sk, d, causal,
# q_offset, sk_valid, cap)
FLASH_EDGES = {
    "sq130": (2, 14, 2, 130, 130, 64, True, 0, None, 130),
    "sq200-of-128": (1, 14, 2, 200, 200, 64, True, 0, None, 200),
    "chunk": (2, 14, 2, 20, 50, 64, True, 30, None, 80),
    "sk_valid": (1, 6, 3, 40, 100, 64, False, 0, 71, 100),
    "causal-sk_valid": (1, 14, 2, 96, 96, 64, True, 0, 70, 120),
    "d8": (2, 4, 2, 33, 33, 8, True, 0, None, 33),
    "d37": (1, 4, 1, 45, 60, 37, True, 15, None, 64),
    "g48-d128": (2, 48, 1, 70, 70, 128, True, 0, None, 90),
    "g12-d128": (2, 24, 2, 70, 100, 128, True, 30, None, 100),
    "sq1-noncausal": (2, 14, 2, 1, 100, 64, False, 0, None, 120),
    "no-key": (1, 4, 2, 30, 40, 64, False, 0, 0, 40),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FLASH_EDGES))
def test_k7_flash_every_plan_at_the_edges_on_card(case, card, monkeypatch):
    """K7 flash under every plan ``plan_flash`` weighs (64 or 128 rows a
    block, a ring of 2 or 3, one or two groups splitting the keys) at rows
    that are no
    multiple of a block's, a chunk against a cache, ``sk_valid`` (0 too),
    D = 8, 37 and 128 with G = 48 and 12, and one query row: one launch a
    call, within 1e-4 of the plain version; the planner's pick gives the
    same bits on two other streams."""
    import repro_torch.kernels.attention.kernel as k7mod
    from repro_torch.kernels.attention.plan import flash_candidates, \
        plan_flash
    b, hq, hkv, sq, sk, d, causal, off, valid, cap = FLASH_EDGES[case]
    q, k, v = _arrays(17, (b, hq, sq, d), (b, hkv, cap, d), (b, hkv, cap, d),
                      scale=0.5)
    kw = dict(causal=causal, q_offset=off, sk_valid=valid)
    want = flash_attention(q, k[:, :, :sk], v[:, :, :sk], **kw).numpy()
    qc, kc, vc = q.to(card), k.to(card)[:, :, :sk], v.to(card)[:, :, :sk]
    for _key, plan in flash_candidates(b, hq, hkv, sq, sk, d, causal, off,
                                       valid):
        monkeypatch.setattr(k7mod, "plan_flash", lambda *a, p=plan: p)
        before = flash_attention.launches
        got = flash_attention(qc, kc, vc, **kw)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        np.testing.assert_allclose(got.cpu().numpy(), want, **TOL,
                                   err_msg=str(plan))
    monkeypatch.setattr(k7mod, "plan_flash", plan_flash)
    case_fn = dict(kernel=lambda: flash_attention(qc, kc, vc, **kw))
    first, outs = _on_two_streams(case_fn)
    assert all(torch.equal(first, o) for o in outs)
    if valid == 0:
        assert not first.any()                  # no key: written as 0


@pytest.mark.cuda
@pytest.mark.parametrize("producer", ["add", "K1", "K7"])
def test_k6_waits_for_its_producer_on_card(producer, card):
    """K6 launches as a programmatic dependent and reads ``w`` before it
    waits: its input x, written by the kernel just before it in the stream
    (a torch add, K1 with its own programmatic launch, or K7 flash), is
    read only once that kernel is done.  Forty calls in a row, each on a
    freshly written x, each equal to the plain version."""
    gen = np.random.default_rng(18)
    if producer == "K7":
        ins = [tuple(t.to(card) for t in _arrays(
            int(gen.integers(1 << 30)), (1, 14, 64, 64), (1, 2, 64, 64),
            (1, 2, 64, 64))) for _ in range(40)]
        make = lambda a: flash_attention(*a)  # noqa: E731
        d = 64
    elif producer == "K1":
        wt = torch.from_numpy(gen.standard_normal((128, 896)).astype(
            np.float32) * 0.1).to(card)
        ins = [torch.from_numpy(gen.standard_normal((16, 128)).astype(
            np.float32)).to(card) for _ in range(40)]
        make = lambda a: matmul_bias_act(a, wt)  # noqa: E731
        d = 896
    else:
        h = torch.from_numpy(gen.standard_normal((16, 896)).astype(
            np.float32)).to(card)
        ins = [torch.from_numpy(gen.standard_normal((16, 896)).astype(
            np.float32)).to(card) for _ in range(40)]
        make = lambda a: a + h  # noqa: E731
        d = 896
    w = torch.from_numpy(gen.standard_normal(d).astype(np.float32)).to(card)
    torch.cuda.synchronize()
    xs, outs = [], []
    for a in ins:
        xs.append(make(a))
        outs.append(rmsnorm(xs[-1], w))
    torch.cuda.synchronize()
    for x, o in zip(xs, outs):
        np.testing.assert_allclose(o.cpu().numpy(),
                                   rmsnorm(x.cpu(), w.cpu()).numpy(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", [(16, 896), (1024, 896), (7, 2500)])
def test_k6_same_bits_on_two_streams_on_card(rows, d, card):
    """K6 a row a block (16 rows), four rows a block (1024), and the general
    kernel past the registers it keeps (d 2500): the same bits on two other
    streams."""
    x, w = (t.to(card) for t in _arrays(19, (rows, d), (d,)))
    first, outs = _on_two_streams(dict(kernel=lambda: rmsnorm(x, w)))
    np.testing.assert_allclose(first.cpu().numpy(),
                               rmsnorm(x.cpu(), w.cpu()).numpy(), **TOL)
    assert all(torch.equal(first, o) for o in outs)


@pytest.mark.cuda
@pytest.mark.parametrize("d,ragged", [(64, False), (64, True), (8, True)])
def test_k7_decode_matches_plain_on_card(d, ragged, card):
    q, k, v = _arrays(10, (3, 14, 1, d), (3, 2, 600, d), (3, 2, 600, d),
                      scale=0.5)
    lens = torch.tensor([513, 1, 576], dtype=torch.int32) if ragged else None
    before = decode_attention.launches
    got = decode_attention(q.to(card), k.to(card)[:, :, :576],
                           v.to(card)[:, :, :576],
                           None if lens is None else lens.to(card))
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    want = decode_attention(q, k[:, :, :576], v[:, :, :576], lens)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **TOL)


@pytest.mark.cuda
def test_lm_path_on_card(card):
    """The smoke config: the card's forward agrees with the CPU's plain
    forward at 1e-4; the engine on two streams gives the tokens of the
    engine on one stream, and launches K6 and K7 as the plan says."""
    cfg = get_smoke("qwen2_0_5b")
    host = init_params(cfg, seed=0)
    params = params_from_numpy(host, card)
    tokens = random_prompts(cfg, 1, 2, 12, seed=2)[0]
    np.testing.assert_allclose(
        forward(params, cfg, tokens.to(card)).cpu().numpy(),
        forward(params_from_numpy(host, "cpu"), cfg, tokens).numpy(), **TOL)
    prompts = random_prompts(cfg, 4, 2, 8, seed=3, device=card)
    runs = []
    for one_stream in (False, True):
        runner = DualMeshRunner(cfg, params,
                                split_streams(card, one_stream=one_stream),
                                max_len=24)
        # warm the decode graph of the groups' width, as the CLI does
        runner.serve(prompts[:2], gen_steps=2, group_size=2)
        before = [f.launches for f in (rmsnorm, flash_attention,
                                       decode_attention)]
        res = runner.serve(prompts, gen_steps=6, group_size=2)
        torch.cuda.synchronize()
        after = [f.launches for f in (rmsnorm, flash_attention,
                                      decode_attention)]
        steps = 2 * 5                       # two groups, 5 decode steps
        per_forward = 2 * cfg.n_layers + 1
        assert [a - b for a, b in zip(after, before)] == [
            (4 + steps) * per_forward, 4 * cfg.n_layers,
            steps * cfg.n_layers]
        runs.append([o.cpu() for o in res.outputs])
    for a, b in zip(*runs):
        assert a.shape == (2, 14) and torch.equal(a, b)


# --------------------------------------------------------------------------
# compiled groups: a CUDA graph per exec group and per decode step
# --------------------------------------------------------------------------
def _runners(model, card, cores=None, **kw):
    """The same model and weights, compiled and eager."""
    params, _, graph = build_model(model, seed=1, device=card)
    sched = build_schedule(graph, DUAL_BASELINE, BoardModel(), "balanced")
    return (DualCoreRunner(model, params, sched, device=card, cores=cores,
                           **kw),
            DualCoreRunner(model, params, sched, device=card,
                           jit_groups=False), graph)


@pytest.mark.cuda
@pytest.mark.parametrize("one_stream", [False, True])
@pytest.mark.parametrize("model", ["mobilenet_v2", "mobilenet_v1",
                                   "squeezenet"])
def test_graphs_bit_equal_eager_on_card(model, one_stream, card):
    """Each model at 64 px: the engine on graphs gives the eager engine's
    bits, on two streams and on one, and the replays count the plan's
    launches per image; a second run reuses the lanes."""
    cores = DualCores(resolve_device(card), one_stream=one_stream)
    fast, eager, graph = _runners(model, card, cores=cores)
    assert fast.jit_groups and fast.donate and not eager.jit_groups
    images = [t.to(card) for t in _arrays(3, *[(2, 64, 64, 3)] * 4)]
    want = stream_images(eager, images).outputs
    fast.run_sequential(images[:1])                   # warm-up and capture
    per_image = Counter(_kernel_of(s, graph) for g in fast.groups
                        for s in g.steps)
    for _ in range(2):
        before = {fn: fn.launches for fn in WRAPPERS.values()}
        got = stream_images(fast, images).outputs
        for fn in WRAPPERS.values():
            assert fn.launches - before[fn] == 4 * per_image[fn]
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    lanes = fast.lanes.count
    assert 1 <= lanes <= min(4, len(fast.groups))
    assert fast.lanes.count == lanes and fast.capture_s > 0


@pytest.mark.cuda
def test_graphs_queued_back_to_back_grow_lanes_on_card(card):
    """8 requests placed at once, each holding its lane, then queued
    through every group with no host wait: the pool grows to 8 lanes and
    every output is the eager sequential forward's; a second pass reuses
    the 8 lanes, each behind its last request's event.  Without donation
    each group's env is the request's own, and the bits are the same."""
    fast, eager, _ = _runners("mobilenet_v2", card)
    images = [t.to(card) for t in _arrays(4, *[(2, 64, 64, 3)] * 8)]
    want = eager.run_sequential(images)
    for _ in range(2):
        envs = [fast.place_input(x) for x in images]
        for i, env in enumerate(envs):
            for h in fast.handles:
                env = h(env)
            envs[i] = env
        for env, b in zip(envs, want):
            wait_ready(env)
            assert torch.equal(env["out"], b)
        assert fast.lanes.count == 8
    kept, _, _ = _runners("mobilenet_v2", card, donate=False)
    assert not kept.donate
    for a, b in zip(stream_images(kept, images).outputs, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_graphs_relocated_mid_flight_on_card(card):
    """Requests in flight when the runner moves to another pool's cores
    finish there on the lanes they hold (their graphs captured in the old
    partitions, which outlive them), with the same bits."""
    fast, eager, _ = _runners("mobilenet_v1", card)
    images = [t.to(card) for t in _arrays(5, *[(2, 64, 64, 3)] * 3)]
    want = eager.run_sequential(images)
    fast.run_sequential(images[:1])
    handles = fast.handles
    envs = []
    for x in images:
        env = fast.place_input(x)
        for h in handles[:2]:
            env = h(env)
        envs.append(env)
    fast.relocate(DualCores(resolve_device(card), 0.25))
    for i, env in enumerate(envs):
        for h in handles[2:]:
            env = h(env)
        wait_ready(env)
        assert torch.equal(env["out"], want[i])


@pytest.mark.cuda
def test_graph_capture_refuses_a_host_sync_on_card(card):
    """A step that waits for the card on the host cannot be captured: the
    capture raises naming the group and the step, and nothing falls back
    to the eager path."""
    fast, _, _ = _runners("squeezenet", card)
    group = fast.groups[1]
    step = group.steps[0]

    def syncing(params, env, collect):
        step.fn(params, env, collect)
        torch.cuda.current_stream().synchronize()

    group.steps[0] = dataclasses.replace(step, fn=syncing)
    x = _arrays(6, (1, 64, 64, 3))[0].to(card)
    with pytest.raises(RuntimeError, match=f"exec group 1 .*{step.name}"):
        fast.run_sequential([x])
    assert fast.lanes.count == 0
    torch.cuda.synchronize()                 # the card is still usable


@pytest.mark.cuda
def test_decode_graph_bit_equal_eager_on_card(card):
    """The smoke LM: a decode group on graphs and the same group eager,
    step by step over 8 steps across a fuse of three streams and an
    eviction of one: logits and tokens bit-equal; then the engines on
    both give the same tokens."""
    cfg = get_smoke("qwen2_0_5b")
    params = params_from_numpy(init_params(cfg, seed=0), card)
    prompts = random_prompts(cfg, 3, 1, 8, seed=4, device=card)
    runs = []
    for jit in (True, False):
        r = DualMeshRunner(cfg, params, split_streams(card), max_len=24,
                           jit_groups=jit)
        streams = [r.run_prefill(r.new_stream(p, gen, rid=i))
                   for i, (p, gen) in enumerate(zip(prompts, (3, 9, 9)))]
        g = r._fuse(streams)
        logits, outs = [], {}
        for _ in range(8):
            r._decode_group(g, 1)
            r.dual.cores.synchronize()      # the p-core's replay is done
            logits.append(g.lane.logits.clone())
            if min(m.remaining for m in g.members) <= 0:
                g = r._evict(g, outs)
        assert (r.lanes.count > 0) and (g.lane.graph is not None) == jit
        r.dual.cores.synchronize()
        runs.append((logits, {k: v[0].clone() for k, v in outs.items()},
                     g.lane.seq[:, :g.pos + 1].clone()))
    (la, oa, sa), (lb, ob, sb) = runs
    assert [x.shape[0] for x in la] == [3] * 3 + [2] * 5
    for a, b in zip(la, lb):
        assert torch.equal(a, b)
    assert oa.keys() == ob.keys() == {0}
    assert torch.equal(oa[0], ob[0]) and torch.equal(sa, sb)
    served = []
    for jit in (True, False):
        r = DualMeshRunner(cfg, params, split_streams(card), max_len=24,
                           jit_groups=jit)
        res = r.serve(prompts, gen_steps=[4, 7, 7], group_size=3)
        served.append([o.cpu() for o in res.outputs])
    for a, b in zip(*served):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("width", ["smoke", "full_2l"])
def test_moe_decode_graph_bit_equal_eager_on_card(width, card):
    """Qwen-MoE (smoke width, and full width cut to 2 layers): a fused
    decode step of 4 rows (the dense branch) captured as a graph and
    replayed, bit-equal to the same step run eagerly, step by step; the
    prefills take the scatter branch (threshold lowered at smoke width,
    2 x 512 tokens at full width)."""
    from repro_torch.configs.registry import get_arch
    name = "qwen2_moe_a2_7b"
    if width == "smoke":
        cfg = dataclasses.replace(get_smoke(name), moe_dense_threshold=4)
        plen = 8
    else:
        cfg = get_arch(name).scaled(name=f"{name}_2l", n_layers=2)
        plen = 512
    params = params_from_numpy(init_params(cfg, seed=0), card)
    prompts = random_prompts(cfg, 2, 2, plen, seed=4, device=card)
    runs = []
    for jit in (True, False):
        r = DualMeshRunner(cfg, params, split_streams(card),
                           max_len=plen + 8, jit_groups=jit)
        streams = [r.run_prefill(r.new_stream(p, 6, rid=i))
                   for i, p in enumerate(prompts)]
        g = r._fuse(streams)
        logits = []
        for _ in range(5):
            r._decode_group(g, 1)
            r.dual.cores.synchronize()
            logits.append(g.lane.logits.clone())
        assert (g.lane.graph is not None) == jit
        runs.append((logits, g.lane.seq[:, :g.pos + 1].clone()))
    (la, sa), (lb, sb) = runs
    for a, b in zip(la, lb):
        assert torch.isfinite(a).all() and torch.equal(a, b)
    assert torch.equal(sa, sb)


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 16], ids=["G1", "G16"])
@pytest.mark.parametrize("lens", [None, [576, 0, 1, 300]],
                         ids=["full", "ragged"])
def test_k7_decode_at_d80_on_card(g, lens, card):
    """K7 decode at Zamba2's head width, 80 (no power of two), on the CUDA
    cores (G 1) and the tensor cores (G 16), whole or ragged down to
    ``kv_len`` 0 and 1: one launch a call, within 1e-4 of the plain
    version, the same bits on two other streams."""
    call = dict(kernel="decode_attention", b=4, hq=2 * g, hkv=2, sk=576,
                d=80, cap=600, kv_len=lens)
    case = chip_smoke.make_case(call, np.random.default_rng(17))
    before = decode_attention.launches
    got = case["kernel"]()
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    want = case["plain"]()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)
    if lens is not None:
        assert not got[1].any()                 # kv_len 0: written as 0
    first, outs = _on_two_streams(case)
    assert torch.equal(first, got) and all(torch.equal(got, o)
                                           for o in outs)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["xlstm_350m", "zamba2_2_7b"])
def test_ssm_decode_graph_bit_equal_eager_on_card(name, card):
    """xLSTM and Zamba2 at smoke width: a fused decode group of two
    streams (their SSM states, convolution tails and shared-block KV
    caches in the lane) captured as a graph and replayed, bit-equal to the
    same steps run eagerly, step by step; then an eviction moves every
    field's rows and the graph of the narrower lane goes on bit-equal."""
    cfg = get_smoke(name)
    params = params_from_numpy(init_params(cfg, seed=0), card)
    prompts = random_prompts(cfg, 2, 2, 8, seed=4, device=card)
    runs = []
    for jit in (True, False):
        r = DualMeshRunner(cfg, params, split_streams(card), max_len=24,
                           jit_groups=jit)
        streams = [r.run_prefill(r.new_stream(p, gen, rid=i))
                   for i, (p, gen) in enumerate(zip(prompts, (3, 8)))]
        g = r._fuse(streams)
        assert set(g.lane.cache) == ({"ssm"} if name == "xlstm_350m" else
                                     {"ssm", "conv", "shared_k", "shared_v"})
        logits, outs = [], {}
        for _ in range(6):
            r._decode_group(g, 1)
            r.dual.cores.synchronize()
            logits.append(g.lane.logits.clone())
            if min(m.remaining for m in g.members) <= 0:
                g = r._evict(g, outs)
        assert (g.lane.graph is not None) == jit
        r.dual.cores.synchronize()
        runs.append((logits, {k: v[0].clone() for k, v in outs.items()},
                     g.lane.seq[:, :g.pos + 1].clone()))
    (la, oa, sa), (lb, ob, sb) = runs
    assert [x.shape[0] for x in la] == [4] * 3 + [2] * 3
    for a, b in zip(la, lb):
        assert torch.isfinite(a).all() and torch.equal(a, b)
    assert oa.keys() == ob.keys() == {0}
    assert torch.equal(oa[0], ob[0]) and torch.equal(sa, sb)


@pytest.mark.cuda
def test_search_on_card_makes_no_green_context(card):
    """The design-flow search plans on the card's SM counts alone: the
    number of green contexts is the same before and after, and the plan
    takes the card's memory and SM count; serving at its theta makes (or
    reuses) the one split of its count."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.dualmesh.schedule import request_stages
    from repro_torch.dualmesh.search import card_model, search

    cfg = get_arch("qwen2_0_5b")
    hw = card_model(card)
    props = torch.cuda.get_device_properties(card)
    assert (hw.mem_bytes, hw.sm_count) == (props.total_memory,
                                           props.multi_processor_count)
    before = len(green._SPLITS)
    res = search(request_stages(cfg, [(2, 512, 64)]), cfg, hw=hw,
                 max_evals=10, n_streams=8)
    assert len(green._SPLITS) == before
    assert res.sms == props.multi_processor_count and len(res.visited) > 1
    dual = split_streams(card, res.theta)
    assert dual.cores.sms("c") == res.dual.c_sms
    assert dual.c_share == res.dual.c_share


# --------------------------------------------------------------------------
# the c/p split of the card's SMs (green contexts)
# --------------------------------------------------------------------------
def _probe(card, stream, capture=None) -> set[int]:
    """The SMs a probe launch on ``stream`` ran on (captured on
    ``capture`` and replayed on ``stream``, given ``capture``)."""
    total = torch.cuda.get_device_properties(card).multi_processor_count
    return set(green.probe_set(card, stream, 2 * total, capture=capture))


@pytest.mark.cuda
@pytest.mark.parametrize("theta", [0.25, 0.5, 0.75])
def test_split_probe_sets_disjoint_on_card(theta, card):
    """At each theta the two cores' SMs are disjoint and of the split's
    sizes, eagerly and in a graph captured on the core's capture stream
    and replayed on a plain stream; together they are the whole card."""
    dev = resolve_device(card)
    cores = DualCores(dev, theta)
    total = torch.cuda.get_device_properties(dev).multi_processor_count
    assert cores.sm_split and cores.sms("c") + cores.sms("p") == total
    assert cores.sms("c") == green.split_count(theta, total)
    assert cores.theta == cores.sms("c") / total and cores.asked == theta
    plain = torch.cuda.Stream(dev)
    eager, replayed = {}, {}
    for core in "cp":
        eager[core] = _probe(dev, cores.streams[core])
        replayed[core] = _probe(dev, plain, cores.capture_stream(core))
        assert len(eager[core]) == len(replayed[core]) == cores.sms(core)
    assert not eager["c"] & eager["p"]
    assert not replayed["c"] & replayed["p"]
    assert len(eager["c"] | eager["p"]) == total


@pytest.mark.cuda
def test_resplit_recaptures_in_the_new_partition_on_card(card):
    """A runner relocated onto re-split cores drops its lanes and captures
    new ones whose graphs run on the new c-core's SMs (a probe launched
    inside the first c-group's graph says where), with the same bits; a
    resplit to the same count keeps the split and the lanes."""
    dev = resolve_device(card)
    fast, eager, _ = _runners("squeezenet", card, cores=DualCores(dev, 0.5))
    first = fast.cores.split
    gi = next(i for i, g in enumerate(fast.groups) if g.core == "c")
    step = fast.groups[gi].steps[0]
    probes = []

    def probing(params, env, collect):
        step.fn(params, env, collect)
        probes.append(green.probe_sms(dev, 264))

    fast.groups[gi].steps[0] = dataclasses.replace(step, fn=probing)
    images = [t.to(card) for t in _arrays(12, *[(1, 64, 64, 3)] * 2)]
    want = eager.run_sequential(images)
    for theta in (0.5, 0.25):
        if theta != 0.5:
            lanes = fast.lanes
            fast.relocate(fast.cores.resplit(theta))
            assert fast.lanes is not lanes and fast.lanes.count == 0
        c_sms = _probe(dev, fast.cores.streams["c"])
        assert len(c_sms) == fast.cores.sms("c")
        got = fast.run_sequential(images)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        captured = probes[-1]                # the lane's graph's output
        fast.cores.synchronize()
        ids = captured.cpu().tolist()
        assert min(ids) >= 0 and set(ids) <= c_sms
    # a count split before gives back its split, streams and all; a
    # relocation onto the split the lanes were captured in keeps them
    assert DualCores(dev, 0.5).split is first
    again = fast.cores.resplit(0.25)
    assert again.split is fast.cores.split
    assert again.streams == fast.cores.streams
    lanes = fast.lanes
    fast.relocate(again)
    assert fast.lanes is lanes and lanes.count > 0
    for a, b in zip(fast.run_sequential(images), want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["mobilenet_v2", "mobilenet_v1",
                                   "squeezenet"])
def test_split_bit_equal_shared_on_card(model, card):
    """Each model at 64 px on graphs: split cores at 0.25 and 0.5 and
    shared ones (``sm_split=False``) give the same bits."""
    dev = resolve_device(card)
    shared, _, _ = _runners(model, card,
                            cores=DualCores(dev, sm_split=False))
    assert not shared.cores.sm_split and "share all" in \
        shared.cores.describe()
    images = [t.to(card) for t in _arrays(13, *[(2, 64, 64, 3)] * 3)]
    want = stream_images(shared, images).outputs
    for theta in (0.25, 0.5):
        split, _, _ = _runners(model, card, cores=DualCores(dev, theta))
        assert "green contexts" in split.cores.describe()
        for a, b in zip(stream_images(split, images).outputs, want):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_fleet_split_bit_equal_shared_on_card(card):
    """Two CNNs as one fleet on a split pool and on a shared one: the same
    bits; the shared pool's stats say it is not split."""
    models = ["mobilenet_v1", "squeezenet"]
    images = [t.to(card) for t in _arrays(14, *[(1, 64, 64, 3)] * 4)]
    outs = {}
    for sm_split in (True, False):
        fleet, pool = build_cnn_fleet(
            models, seed=1, pool=DevicePool(card, sm_split=sm_split))
        assert pool.stats()["sm_split"] is sm_split
        assert ("sms" in pool.stats()) is sm_split
        for i, x in enumerate(images):
            fleet.submit(Request(x, model=models[i % 2]))
        outs[sm_split] = fleet.drain().outputs
    for a, b in zip(outs[True], outs[False]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_decode_split_tokens_equal_shared_on_card(card):
    """The smoke LM on split cores (each decode step's graph captured on
    the p-core) and on shared ones: the same tokens."""
    cfg = get_smoke("qwen2_0_5b")
    params = params_from_numpy(init_params(cfg, seed=0), card)
    prompts = random_prompts(cfg, 3, 1, 8, seed=4, device=card)
    served = []
    for sm_split in (True, False):
        dual = split_streams(card, 0.5, sm_split=sm_split)
        assert dual.cores.sm_split is sm_split
        r = DualMeshRunner(cfg, params, dual, max_len=24)
        res = r.serve(prompts, gen_steps=[4, 7, 7], group_size=3)
        assert r.lanes.count > 0 and (r.dual.cores.split is None) != sm_split
        served.append([o.cpu() for o in res.outputs])
    for a, b in zip(*served):
        assert torch.equal(a, b)


class _Without:
    """``libcuda`` as loaded, without the symbol ``missing``."""

    def __init__(self, lib, missing: str):
        self._lib, self._missing = lib, missing

    def __getattr__(self, name):
        if name == self._missing:
            raise AttributeError(name)
        return getattr(self._lib, name)


@pytest.mark.cuda
@pytest.mark.parametrize("missing", ["cuDevSmResourceSplitByCount",
                                     "cuGreenCtxStreamCreate"])
def test_a_split_libcuda_cannot_make_raises_on_card(missing, card,
                                                       monkeypatch):
    """Without green contexts in ``libcuda`` every path that splits raises
    naming the symbol; nothing runs on shared streams unless asked."""
    real = ctypes.CDLL
    monkeypatch.setattr(green, "_DRIVER", [])
    monkeypatch.setattr(green.ctypes, "CDLL",
                        lambda path: _Without(real(path), missing))
    dev = resolve_device(card)
    for make in (lambda: DualCores(dev), lambda: DevicePool(card),
                 lambda: split_streams(card),
                 lambda: build_cnn_fleet(["squeezenet"], device=card)):
        with pytest.raises(green.GreenContextError, match=missing):
            make()
    assert not DualCores(dev, sm_split=False).sm_split


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["mobilenet_v2", "mobilenet_v1"])
def test_measured_split_bit_equal_half_on_card(model, card):
    """A runner that measures its split at 224 px: it ends on the count
    of the lower measured slot bound, which its cores realise,
    holding one lane after the search; every lane replayed after it runs
    its c-groups on that count's c-core SMs (a probe launched inside the
    first c-group's graph says where); the counter and gauge agree; and
    it serves the bits of a runner split at theta 0.5."""
    dev = resolve_device(card)
    params, _, graph = build_model(model, seed=1, device=card)
    sched = build_schedule(graph, DUAL_BASELINE, BoardModel(), "balanced")
    half = DualCoreRunner(model, params, sched, device=card, theta=0.5)
    fast = DualCoreRunner(model, params, sched, device=card)
    assert fast.cores.sms("c") == half.cores.sms("c") == 64
    gi = next(i for i, g in enumerate(fast.groups) if g.core == "c")
    step = fast.groups[gi].steps[0]
    probes = []

    def probing(params, env, collect):
        step.fn(params, env, collect)
        probes.append(green.probe_sms(dev, 264))

    fast.groups[gi].steps[0] = dataclasses.replace(step, fn=probing)
    fast.obs = Registry()
    images = [t.to(card) for t in _arrays(21, *[(8, 224, 224, 3)] * 6)]
    fast.run_sequential(images[:1])
    key = (tuple(images[0].shape), images[0].dtype)
    assert list(fast.lanes.lanes) == [key]
    assert len(fast.lanes.lanes[key]) == 1
    chosen = fast.cores.sms("c")
    tried = {p.count: p.bound for p in fast.cores.balance if not p.refused}
    assert tried[chosen] == min(tried.values())
    assert chosen + fast.cores.sms("p") == fast.cores.split.total
    assert fast.cores.split is DualCores(dev, chosen /
                                         fast.cores.split.total).split
    assert "c count measured" in fast.cores.describe()
    snap = fast.obs.snapshot()
    assert snap["gauges"]["runner_split_c_sms"]["series"] == {"": chosen}
    made = snap["counters"]["runner_split_probes_total"]["series"][""]
    assert made == len(fast.cores.balance) - 1 <= 1
    fast.cores.synchronize()
    for t in probes:
        t.fill_(-1)
    want = stream_images(half, images).outputs
    got = stream_images(fast, images).outputs
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    fast.cores.synchronize()
    c_sms = _probe(dev, fast.cores.streams["c"])
    assert len(c_sms) == chosen
    written = [set(t.cpu().tolist()) for t in probes]
    written = [w for w in written if w != {-1}]
    assert written and all(min(w) >= 0 and w <= c_sms for w in written)
    assert fast.cores.sms("c") == chosen        # decided once


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["theta", "leased", "shared", "eager"])
def test_runners_that_measure_nothing_keep_their_split_on_card(how, card):
    """An explicit theta, leased cores, cores on shared SMs and eager
    groups: no search, the split given kept, no probe counted."""
    dev = resolve_device(card)
    params, _, graph = build_model("mobilenet_v1", seed=1, device=card)
    sched = build_schedule(graph, DUAL_BASELINE, BoardModel(), "balanced")
    kw = {"theta": {"theta": 0.25},
          "leased": {"cores": DualCores(dev, 0.75)},
          "shared": {"cores": DualCores(dev, sm_split=False)},
          "eager": {"jit_groups": False}}[how]
    runner = DualCoreRunner("mobilenet_v1", params, sched, device=card, **kw)
    before = runner.cores
    runner.obs = Registry()
    runner.run_sequential([t.to(card) for t in _arrays(22, (2, 64, 64, 3))])
    assert runner.cores is before and runner.cores.balance is None
    want = {"theta": 32, "leased": 96, "shared": None, "eager": 64}[how]
    assert runner.cores.sms("c") == want
    snap = runner.obs.snapshot()
    assert "runner_split_probes_total" not in snap["counters"]
    assert "runner_split_c_sms" not in snap["gauges"]


@pytest.mark.cuda
def test_lm_plan_prices_each_core_on_card(card):
    """On a split card each core's share is its SMs over the card's, and
    the plan at theta 0.25 differs from the plan at 0.75; without a split
    both shares are 1."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.dualmesh.cost import CardModel
    from repro_torch.dualmesh.schedule import plan_admission

    cfg = get_arch("qwen2_0_5b")
    plans = {}
    for theta in (0.25, 0.75):
        dual = split_streams(card, theta)
        total = dual.cores.split.total
        assert dual.c_share == dual.cores.sms("c") / total
        assert dual.p_share == dual.cores.sms("p") / total
        p = plan_admission(cfg, dual, CardModel(), 2, 512, 64, 8)
        plans[theta] = (p.group_size, p.est_makespan)
    assert plans[0.25] != plans[0.75]
    whole = split_streams(card, 0.5, sm_split=False)
    assert (whole.c_share, whole.p_share) == (1.0, 1.0)


@pytest.mark.cuda
def test_cnn_workers_bit_equal_in_process_fleet_on_card(card, tmp_path):
    """Two CNN worker processes on the card (each its own context and its
    own split) serve 6 requests with a migration: each output bit-equal to
    an in-process fleet's on the card, every request retired once, and
    each worker's launches after its warm-up as the plans say for the
    requests it served."""
    from repro_torch.fleet import (MultiPoolRouter, connect, start_workers,
                                   stop_workers)
    from repro_torch.fleet.net.worker import LAUNCHES_PREFIX
    from repro_torch.kernels.util import timed_build

    timed_build()                   # the parent builds; workers only load
    models = ["mobilenet_v1", "squeezenet"]
    xs = _arrays(15, *[(1, 64, 64, 3)] * 6)
    fleet, _ = build_cnn_fleet(models, device=card, burst=4)
    for x, i in zip(xs, range(6)):
        fleet.submit(Request(x.to(card), model=models[i % 2]))
    want = [o.cpu() for o in fleet.drain().outputs]
    per_request = {m: Counter(c["kernel"] for c in chip_smoke.plan_calls(
        *chip_smoke.served_plan(m), 1)) for m in models}
    log = tmp_path / "workers.err"
    wargs = ["--models", ",".join(models), "--image-size", "64",
             "--batch", "1", "--burst", "4"]
    with open(log, "w") as err:
        procs = start_workers({p: wargs for p in ("pool0", "pool1")},
                              stderr=err, ready_timeout_s=600.0)
        fleets = {}
        try:
            fleets = connect(procs)
            router = MultiPoolRouter(fleets)
            for x, i in zip(xs, range(6)):
                router.submit(Request(x, model=models[i % 2]))
            assert router.migrate("pool1", "pool0", count=1) == 1
            res = router.drain()
        finally:
            stop_workers(fleets, procs)
    assert [c.status for c in res.completions] == ["ok"] * 6
    assert router.duplicates_dropped == 0
    for a, b in zip(res.outputs, want):
        assert a.device.type == "cpu" and torch.equal(a, b)
    docs = [json.loads(ln[len(LAUNCHES_PREFIX):])
            for ln in log.read_text().splitlines()
            if ln.startswith(LAUNCHES_PREFIX)]
    assert sorted(d["pool"] for d in docs) == ["pool0", "pool1"]
    for d in docs:
        served = res.stats["pools"][d["pool"]]["served"]
        want_n = Counter()
        for m, n in served.items():
            for k, v in per_request[m].items():
                want_n[k] += n * v
        assert {k: v for k, v in d["launches"].items() if v} == \
            dict(want_n)


# --------------------------------------------------------------------------
# the closed-loop controller
# --------------------------------------------------------------------------
@pytest.mark.cuda
def test_controlled_fleet_replays_bitwise_on_card(card):
    """mobilenet_v1 + squeezenet at 64 px under a ``ControlLoop`` whose
    traffic flips from 3:1 to 1:3: the reweights land in the stream, and
    the stream and the decision log through JSON replay on a fresh fleet
    with no controller: the same signature, every output bit-equal, the
    log verifying and the same final weights."""
    from repro_torch.fleet import (ControlLoop, decisions_from_json,
                                   decisions_to_json, stream_from_json,
                                   stream_signature, stream_to_json,
                                   verify_decisions)
    from repro_torch.serving.api import replay

    models = ["mobilenet_v1", "squeezenet"]
    xs = [x.to(card) for x in _arrays(21, *[(1, 64, 64, 3)] * 4)]
    tags = ([models[0]] * 3 + [models[1]]) * 4 + \
        ([models[1]] * 3 + [models[0]]) * 4
    arrivals = list(range(len(tags)))

    def build():
        fleet, _ = build_cnn_fleet(models, device=card, burst=4,
                                   policy=make_policy("weighted_fair"))
        for m in fleet.members:        # warm each member, as the CLI does
            m.engine.runner.run_sequential(xs[:1])
        return fleet

    def requests():
        return [Request(xs[i % 4], model=t) for i, t in enumerate(tags)]

    live = build()
    ctl = ControlLoop(live, interval=4)
    res = replay(live, requests(), arrivals)
    assert [c.status for c in res.completions] == ["ok"] * len(tags)
    assert res.stats["control"]["by_kind"].get("reweight")
    stream = stream_from_json(json.loads(json.dumps(stream_to_json(
        live.stream))))
    log = decisions_from_json(json.loads(json.dumps(decisions_to_json(
        ctl.decisions))))
    fresh = build()
    assert fresh.controller is None
    rep = fresh.executor.replay(stream, requests(), arrivals)
    assert stream_signature(fresh.stream) == stream_signature(live.stream)
    for a, b in zip(rep.outputs, res.outputs):
        assert torch.equal(a, b)
    verify_decisions(fresh.stream, log)
    assert [m.weight for m in fresh.members] == \
        [m.weight for m in live.members]


@pytest.mark.cuda
def test_retune_mid_run_draws_on_captured_lanes_on_card(card):
    """The smoke LM as a fleet member under a controller whose SLO lies
    below every latency: its first request finishes early, so Retune
    halves the fusion width 4 -> 2 while the second still decodes, and the
    three that arrive next fuse 2 + 1 (4 would have fused all 3) on decode
    lanes captured before the run (no capture during it); K6 and K7 launch
    as the plan says, and the recorded stream replays bitwise on a fresh
    uncontrolled fleet."""
    from repro_torch.fleet import ControlLoop, FleetEngine, stream_signature
    from repro_torch.serving.api import replay
    from repro_torch.serving.lm import DualMeshEngine

    cfg = get_smoke("qwen2_0_5b")
    params = params_from_numpy(init_params(cfg, seed=0), card)
    prompts = random_prompts(cfg, 5, 2, 8, seed=4, device=card)
    gens, arrivals = [2, 6, 6, 6, 6], [0, 0, 2, 2, 2]
    runner = DualMeshRunner(cfg, params, split_streams(card), max_len=24)
    chip_smoke.capture_decode_lanes(runner, [2, 4, 6, 8], 2)
    captured = runner.lanes.count

    def build():
        return FleetEngine({"lm": DualMeshEngine(runner, group_size=4,
                                                 quantum=2)}, burst=2)

    def requests():
        return [Request(p, gen_steps=g, model="lm")
                for p, g in zip(prompts, gens)]

    live = build()
    ctl = ControlLoop(live, interval=2, slo_ms=1e-3)
    fns = (rmsnorm, flash_attention, decode_attention)
    before = [f.launches for f in fns]
    res = replay(live, requests(), arrivals)
    after = [f.launches for f in fns]
    lm = live._by_name["lm"].engine
    assert [d.action.value for d in ctl.decisions
            if d.action.kind == "retune"] == [2, 1]
    assert lm.fused_sizes == [2, 2, 1]
    assert runner.lanes.count == captured
    steps = 5 * len(lm.fused_sizes)         # each group lives 5 steps
    per_forward = 2 * cfg.n_layers + 1
    assert [a - b for a, b in zip(after, before)] == [
        (5 + steps) * per_forward, 5 * cfg.n_layers, steps * cfg.n_layers]
    assert [tuple(o.shape) for o in res.outputs] == \
        [(2, 8 + g) for g in gens]
    fresh = build()
    rep = fresh.executor.replay(list(live.stream), requests(), arrivals)
    assert stream_signature(fresh.stream) == stream_signature(live.stream)
    assert runner.lanes.count == captured
    for a, b in zip(rep.outputs, res.outputs):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# Training: the backward kernels and a train step on the card
# --------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("call", chip_smoke.train_calls()
                         + chip_smoke.train_edge_calls(),
                         ids=lambda c: f"{c['kernel']}-"
                         + chip_smoke._shape_str(c).replace(" ", "-"))
def test_train_kernel_matches_plain_on_card(call, card):
    """K6's and K7 flash's backward kernels (and the forwards as training
    launches them) against their plain versions at rtol = atol = 1e-4,
    the same bits when run twice (``chip_smoke.check_train_call``); each
    output's largest error within 1e-4 of its largest magnitude (K6's dw
    sums 4096 rows to magnitudes near 64, so an absolute 1e-4 on the
    error alone would hold it tighter than f32 sums in another order)."""
    from repro_torch.kernels.util import COUNTED
    fn = COUNTED[call["kernel"]]
    before = fn.launches
    row = chip_smoke.check_train_call(call, np.random.default_rng(0),
                                      timing=False)
    assert fn.launches == before + 2
    assert np.isfinite(row["max_abs_err"])
    assert row["max_rel_err"] <= chip_smoke.BWD_TOL


# K7 flash's backward at the planner's edges: (b, hq, hkv, sq, sk, d,
# causal, q_offset, sk_valid, cap)
FLASH_BWD_EDGES = {
    "sq130": (2, 14, 2, 130, 130, 64, True, 0, None, 130),
    "keys-past-a-tile": (1, 4, 2, 100, 100, 64, True, 0, None, 100),
    "few-blocks": (1, 2, 1, 48, 48, 64, True, 0, None, 64),
    "chunk": (2, 14, 2, 20, 50, 64, True, 30, None, 80),
    "sk_valid": (1, 6, 3, 40, 100, 64, False, 0, 71, 100),
    "causal-sk_valid": (1, 14, 2, 96, 96, 64, True, 0, 70, 120),
    "d32": (2, 8, 2, 96, 96, 32, True, 0, None, 96),
    "d37": (1, 4, 1, 45, 60, 37, True, 15, None, 64),
    "d80": (1, 4, 2, 70, 70, 80, True, 0, None, 70),
    "g8-d128": (1, 8, 1, 65, 65, 128, True, 0, None, 65),
    "g14": (1, 14, 1, 90, 90, 64, True, 0, None, 90),
    "noncausal-sq40-sk90": (1, 4, 2, 40, 90, 64, False, 0, None, 90),
    "no-key": (1, 4, 2, 20, 30, 64, True, 0, 0, 30),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FLASH_BWD_EDGES))
def test_k7_flash_bwd_every_plan_at_the_edges_on_card(case, card,
                                                      monkeypatch):
    """K7 flash's backward under every plan ``plan_flash_bwd`` weighs
    (each pass's warps and ring; the dK/dV pass's pairing of key tiles and
    the cluster that splits the group's heads) at keys that are no
    multiple of a key tile, fewer blocks than SMs, a chunk against a cut
    cache, ``sk_valid`` (0 too), D = 32, 37, 80 and 128, G = 8 and 14:
    two launches a call (its dQ and dK/dV passes, counted once), each
    output within rtol = atol = 1e-4 (``chip_smoke.BWD_TOL``) of the plain
    version on the card, the same bits when run twice; the planner's pick
    gives the same bits on two other streams."""
    import repro_torch.kernels.attention.kernel as k7mod
    from repro_torch.kernels.attention.plan import (flash_bwd_candidates,
                                                    plan_flash_bwd)
    from repro_torch.kernels.attention.ref import flash_attention_bwd_ref
    b, hq, hkv, sq, sk, d, causal, off, valid, cap = FLASH_BWD_EDGES[case]
    q, k, v, dout = _arrays(23, (b, hq, sq, d), (b, hkv, cap, d),
                            (b, hkv, cap, d), (b, hq, sq, d), scale=0.5)
    q, dout = q.to(card), dout.to(card)
    k, v = k.to(card)[:, :, :sk], v.to(card)[:, :, :sk]
    kw = dict(causal=causal, q_offset=off, sk_valid=valid)
    out, lse = k7mod._flash_forward(q, k, v, causal, off, valid, True)
    want = flash_attention_bwd_ref(q, k, v, out, dout, lse, **kw)
    fn = k7mod.flash_attention_bwd
    plans = flash_bwd_candidates(b, hq, hkv, sq, sk, d, causal, off, valid)
    for _key, plan in plans:
        monkeypatch.setattr(k7mod, "plan_flash_bwd", lambda *a, p=plan: p)
        before = fn.launches
        got = fn(q, k, v, out, dout, lse, **kw)
        again = fn(q, k, v, out, dout, lse, **kw)
        torch.cuda.synchronize()
        assert fn.launches == before + 2
        for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
            assert torch.equal(g, a), f"{name} differs run to run: {plan}"
            torch.testing.assert_close(
                g, w, rtol=chip_smoke.BWD_TOL, atol=chip_smoke.BWD_TOL,
                msg=lambda m, n=name, p=plan: f"{n} {p}: {m}")
    monkeypatch.setattr(k7mod, "plan_flash_bwd", plan_flash_bwd)
    first, outs = _on_two_streams(dict(
        kernel=lambda: torch.cat([t.flatten() for t in fn(
            q, k, v, out, dout, lse, **kw)])))
    assert all(torch.equal(first, o) for o in outs)
    if valid == 0:
        assert not first.any()                  # no key: every gradient 0


@pytest.mark.cuda
def test_flash_output_bits_without_lse_on_card(card):
    """K7 flash's output is the same with and without the log-sum-exp
    pointer under every plan, a key split among them."""
    assert chip_smoke.lse_bits(np.random.default_rng(1)) > 5


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2_0_5b", "zamba2_2_7b",
                                  "whisper_small"])
def test_train_step_on_card_matches_plain(arch, card):
    """One step's loss and gradients at the smoke config on the card: the
    kernels (forward and backward) against autograd through the plain
    versions on the card; the launches as the step runs them."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels.util import launch_counts
    from repro_torch.lm.model import load_params
    from repro_torch.lm.steps import batch_to, loss_and_grads
    from repro_torch.train.tree import leaves
    cfg = get_smoke(arch)
    params = load_params(cfg, 0, card)
    raw = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=24,
                                 global_batch=2)).batch_at(0)
    if cfg.encoder_decoder:
        raw["enc_input"] = np.random.default_rng(0).standard_normal(
            (2, cfg.enc_positions, cfg.d_model)).astype(np.float32) * 0.1
    batch = batch_to(raw, card)
    before = launch_counts()
    loss, grads = loss_and_grads(params, cfg, batch)
    torch.cuda.synchronize()
    ran = {k: v - before[k] for k, v in launch_counts().items()
           if v != before[k]}
    assert ran["rmsnorm_bwd"] > 0 and ran.get("flash_attention_bwd", 0) > 0
    assert ran["rmsnorm"] > ran["rmsnorm_bwd"]          # remat recomputes
    with chip_smoke.plain_kernels():
        ploss, pgrads = loss_and_grads(params, cfg, batch)
    np.testing.assert_allclose(float(loss), float(ploss), rtol=1e-5)
    for g, p in zip(leaves(grads), leaves(pgrads)):
        assert bool(torch.isfinite(g).all())
        top = p.abs().max().item()
        assert (g - p).abs().max().item() <= 1e-3 * top


# --------------------------------------------------------------------------
# the int8 KV cache's kernels and the meta branches
# --------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("which", ["path_prefill", "path_decode", "g1_chunk",
                                   "g12_ragged"])
def test_int8_kernels_on_card(which, card):
    """The int8 kernels against their plain versions (chip_smoke's check:
    every element within 1e-5 but the rows a rounding tie flips, each such
    row explained by its ties): Qwen2.5-14B's 2 x 512 prefill and a decode
    at kv_len 545 over the cache of 576; a G 1 chunk at q_offset 63; a G
    12 decode at ragged kv_len down to 5.  One launch a call, the same
    bits on two other streams."""
    from repro_torch.kernels.attention.kernel import (decode_attention_int8,
                                                      flash_attention_int8)
    i8 = chip_smoke._i8
    calls = dict(
        path_prefill=i8("flash_attention_int8", 2, 40, 8, 128, 512, 576,
                        sq=512),
        path_decode=i8("decode_attention_int8", 2, 40, 8, 128, 576, 576,
                       kv_len=[545, 545]),
        g1_chunk=i8("flash_attention_int8", 1, 4, 4, 128, 100, 160, sq=37,
                    q_offset=63),
        g12_ragged=i8("decode_attention_int8", 2, 96, 8, 128, 576, 576,
                      kv_len=[576, 5]))
    call = calls[which]
    fn = (flash_attention_int8 if call["kernel"] == "flash_attention_int8"
          else decode_attention_int8)
    before = fn.launches
    row = chip_smoke.int8_check(call, np.random.default_rng(23), False)
    assert fn.launches == before + 1
    assert row["flips"] <= max(1, 1e-3 * row["rows"])
    case = chip_smoke.int8_case(call, np.random.default_rng(23))
    first, outs = _on_two_streams(case)
    assert all(torch.equal(first, o) for o in outs)


@pytest.mark.cuda
def test_meta_branches_match_cuda_outputs(card):
    """Each LM kernel's meta branch returns what its CUDA branch returns:
    the same shapes and dtypes."""
    from repro_torch.kernels.attention.kernel import (decode_attention_int8,
                                                      flash_attention_bwd,
                                                      flash_attention_int8)
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_bwd
    rng = np.random.default_rng(29)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(card) for s in ((2, 6, 33, 64), (2, 2, 40, 64),
                                        (2, 2, 40, 64), (2, 6, 33, 64)))
    k8 = torch.clamp(torch.round(k * 32), -127, 127).to(torch.int8)
    v8 = torch.clamp(torch.round(v * 32), -127, 127).to(torch.int8)
    x, w = q.reshape(-1, 64).contiguous(), v[0, 0, 0].contiguous()
    lens = torch.tensor([40, 7], dtype=torch.int32, device=card)

    def calls(dev):
        t = {n: a.to(dev) for n, a in dict(q=q, k=k, v=v, dout=dout, k8=k8,
                                           v8=v8, x=x, w=w,
                                           lens=lens).items()}
        from repro_torch.kernels.attention.kernel import _flash_forward
        out, lse = _flash_forward(t["q"], t["k"], t["v"], True, 7, None,
                                  True)
        return [out, lse,
                *flash_attention_bwd(t["q"], t["k"], t["v"], out,
                                     t["dout"], lse, q_offset=7),
                decode_attention(t["q"][:, :, :1].contiguous(), t["k"],
                                 t["v"], t["lens"]),
                flash_attention_int8(t["q"], t["k8"], t["v8"], q_offset=7),
                decode_attention_int8(t["q"][:, :, :1].contiguous(),
                                      t["k8"], t["v8"], t["lens"]),
                rmsnorm(t["x"], t["w"]),
                *rmsnorm_bwd(t["x"], t["w"], t["x"])]

    on_card = calls(card)
    on_meta = calls(torch.device("meta"))
    assert len(on_card) == len(on_meta)
    for a, b in zip(on_card, on_meta):
        assert b.device.type == "meta"
        assert (a.shape, a.dtype) == (b.shape, b.dtype)


# --------------------------------------------------------------------------
# the plan cache (kernels/autotune.py)
# --------------------------------------------------------------------------
#: one signature of each kind K1-K5 at a path shape (224 px, batch 2)
TUNE_SIGS = {
    "K1": dict(kind="pointwise", H=56, W=56, C_i=64, C_o=128, N=2),
    "K2": dict(kind="depthwise", H=112, W=112, C_i=32, C_o=32, K_h=3,
               K_w=3, stride=1, pad=1, N=2),
    "K3": dict(kind="conv", H=55, W=55, C_i=16, C_o=64, K_h=3, K_w=3,
               stride=1, pad=1, N=2, vec=True),
    "K4": dict(kind="fused_dw_pw", H=14, W=14, C_i=512, C_o=512, K_h=3,
               K_w=3, stride=1, pad=1, N=2),
    "K5": dict(kind="fused_pw_dw_pw", H=28, W=28, C_i=192, C_o=32, K_h=3,
               K_w=3, stride=1, pad=1, N=2, C_e=32),
}


@pytest.fixture
def plan_cache(tmp_path, monkeypatch):
    from repro_torch.kernels import autotune
    path = str(tmp_path / "plans.json")
    monkeypatch.setenv(autotune.CACHE_ENV, path)
    autotune.clear_memory_cache()
    yield autotune, path
    autotune.clear_memory_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(TUNE_SIGS))
def test_tune_layer_on_card(kernel, card, plan_cache):
    """One signature a kind tuned on the whole card and on a core: every
    candidate launches and is timed, the entry carries the card's tag with
    the stream's SMs, and the lookup then launches the winner."""
    at, path = plan_cache
    sig = at.LayerSig(**TUNE_SIGS[kernel])
    split = green.split_sms(resolve_device(card), 0.5)
    for stream, sms in ((torch.cuda.current_stream(), None),
                        (split.parts["c"].stream, split.sms("c"))):
        with torch.cuda.stream(stream):
            tag = at.device_tag(card)
            assert tag.endswith(f"/sms{sms or split.total}")
            cfg = at.tune_layer(sig, device=card, reps=1)
            entry = at.load_cache()["entries"][sig.entry_key(tag)]
            assert entry["us"] > 0 and entry["backend"] == tag
            assert None not in entry["candidates_us"]
            assert cfg in at.candidates(sig)
            at.reset_lookups()
            assert at.knobs(sig, at.resolve(sig, resolve_device(card))) \
                == cfg
            assert at.LOOKUPS == {"hit": 1, "miss": 0}
        stream.synchronize()
    assert json.load(open(path))["version"] == 1


@pytest.mark.cuda
def test_the_tuner_tunes_the_cores_of_a_measured_count_on_card(card,
                                                               plan_cache):
    """``--c-sms N`` tunes on the whole card and on both cores of the
    split that gives the c-core N SMs, the count a measuring runner's
    cores line names."""
    at, path = plan_cache
    assert at.main(["--sweep-zoo", "--smoke", "--limit", "1", "--c-sms",
                    "80", "--device", str(card), "--cache", path]) == 0
    total = torch.cuda.get_device_properties(
        resolve_device(card)).multi_processor_count
    entries = json.load(open(path))["entries"]
    assert {k.rsplit("/sms", 1)[1] for k in entries} == {
        str(total), "80", str(total - 80)}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(TUNE_SIGS))
def test_every_candidate_gives_the_planners_bits_on_card(kernel, card):
    """Each candidate's plan launched gives the planner's pick's bits."""
    from repro_torch.kernels import autotune as at
    sig = at.LayerSig(**TUNE_SIGS[kernel])
    call = at.operands(sig, card)
    want = call(at.planner_plan(sig))()
    assert torch.isfinite(want).all()
    for cfg in at.candidates(sig):
        got = call(at.plan_of(sig, cfg))()
        assert torch.equal(got, want), cfg


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["mobilenet_v2", "mobilenet_v1",
                                   "squeezenet"])
def test_split_bit_equal_shared_warmed_cache_on_card(model, card,
                                                     plan_cache):
    """``test_split_bit_equal_shared_on_card`` with a cache warmed for the
    model on the whole card and on each core at 0.25 and 0.5: every K1-K5
    call hits it, and split, shared and uncached runs give the same
    bits."""
    at, _ = plan_cache
    dev = resolve_device(card)
    images = [t.to(card) for t in _arrays(13, *[(2, 64, 64, 3)] * 3)]
    plain, _, _ = _runners(model, card, cores=DualCores(dev, sm_split=False))
    want = stream_images(plain, images).outputs          # no cache yet
    sigs = at.zoo_signatures(64, (model,), 2)
    streams = [torch.cuda.current_stream()]
    for theta in (0.25, 0.5):
        split = green.split_sms(dev, theta)
        streams += [split.parts[c].stream for c in "cp"]
    for stream in streams:
        with torch.cuda.stream(stream):
            for sig in sigs:
                at.tune_layer(sig, device=card, reps=1)
        stream.synchronize()
    for cores in [DualCores(dev, sm_split=False), DualCores(dev, 0.25),
                  DualCores(dev, 0.5)]:
        at.reset_lookups()
        runner, _, _ = _runners(model, card, cores=cores)
        got = stream_images(runner, images).outputs
        assert at.LOOKUPS["miss"] == 0 and at.LOOKUPS["hit"] > 0
        for a, b in zip(got, want):
            assert torch.equal(a, b)


# --------------------------------------------------------------------------
# the engine's spans and counters against the profiler's trace
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def profiled_engine():
    """MobileNet v2 at 64 px on the split card with the engine's spans
    and counters on: 8 requests to capture the lanes, then, under
    ``torch.profiler``, a probe kernel on each core's stream and 8 more
    requests.  Returns the runner, the engine, the spans of the profiled
    run, its events, and the probes' correlation ids."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: python -m pytest -m cuda "
                    "tests/test_torch_cuda.py on a machine with one")
    from torch.profiler import ProfilerActivity, profile, record_function

    card = torch.device("cuda")
    runner, _, _ = _runners("mobilenet_v2", card)
    spans = SpanRecorder(enabled=True)
    eng = DualCoreEngine(runner, obs=Registry(), spans=spans)
    images = [t.to(card) for t in _arrays(21, *[(2, 64, 64, 3)] * 8)]
    for x in images:
        eng.submit(x)
    eng.drain()
    spans.drain()
    probe = torch.zeros(1024, device=card)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for core in "cp":
            with torch.cuda.stream(runner.cores.streams[core]), \
                    record_function(f"probe.{core}"):
                probe.add_(1)
        runner.cores.synchronize()
        for x in images:
            eng.submit(x)
        eng.drain()
        runner.cores.synchronize()
    events = list(prof.profiler.kineto_results.events())
    return runner, eng, spans.drain(), events


def _launches_inside(events, a, b):
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in events
            if e.device_type() != cuda and e.name().startswith("cu")
            and a <= e.start_ns() and e.start_ns() + e.duration_ns() <= b]


@pytest.mark.cuda
def test_engine_spans_tie_each_core_to_its_streams_on_card(profiled_engine):
    """In a profiled run on graphs, every ``cudaGraphLaunch`` lies inside
    a ``runner.group`` span that replayed a graph, one for one; the
    kernels each group launched, found by the launch's correlation id,
    run on streams of the group's core alone: the two cores' streams
    are disjoint, and a kernel launched eagerly on a core's own stream
    lands on them."""
    runner, _, spans, events = profiled_engine
    cuda = torch.autograd.DeviceType.CUDA
    groups = [s for s in spans if s.name == "runner.group"]
    assert groups and all(s.graph for s in groups)
    launches = [e for e in events if e.device_type() != cuda
                and e.name().startswith("cudaGraphLaunch")]
    inside = [[e for e in _launches_inside(events, s.start_ns, s.end_ns)
               if e.name().startswith("cudaGraphLaunch")] for s in groups]
    assert [len(x) for x in inside] == [1] * len(groups)
    assert len(launches) == len(groups)
    by_corr: dict = {}
    for e in events:
        if e.device_type() == cuda and not e.is_user_annotation():
            by_corr.setdefault(e.correlation_id(), []).append(e)
    streams: dict = {"c": set(), "p": set()}
    for s, (launch,) in zip(groups, inside):
        kernels = by_corr.get(launch.correlation_id(), [])
        assert kernels, s
        streams[s.core] |= {k.device_resource_id() for k in kernels}
    assert streams["c"] and streams["p"]
    assert not streams["c"] & streams["p"]
    marks = {e.name(): e for e in events if e.name().startswith("probe.")
             and e.device_type() != cuda}
    for core in "cp":
        mark = marks[f"probe.{core}"]
        (launch,) = [e for e in _launches_inside(
            events, mark.start_ns(), mark.start_ns() + mark.duration_ns())
            if e.correlation_id() in by_corr]
        (kernel,) = by_corr[launch.correlation_id()]
        assert kernel.device_resource_id() in streams[core], core


@pytest.mark.cuda
def test_engine_span_stamps_agree_with_profiler_annotations_on_card(
        profiled_engine):
    """While a profiler runs, each span is also a ``record_function`` of
    its name: every recorded span has its annotation, and the two agree
    within 50 us at both ends."""
    _, _, spans, events = profiled_engine
    cuda = torch.autograd.DeviceType.CUDA
    marks: dict = {}
    for e in events:
        if e.device_type() != cuda and e.is_user_annotation():
            marks.setdefault(e.name(), []).append(e)
    names = {s.name for s in spans}
    assert {"engine.advance", "engine.retire", "engine.ready_wait",
            "engine.admit", "runner.load", "runner.group",
            "runner.clone_out"} <= names
    for name in names:
        mine = sorted((s for s in spans if s.name == name),
                      key=lambda s: s.start_ns)
        theirs = sorted(marks.get(name, []), key=lambda e: e.start_ns())
        assert len(theirs) == len(mine), name
        for s, e in zip(mine, theirs):
            assert abs(e.start_ns() - s.start_ns) <= 50_000, (name, s)
            assert abs(e.start_ns() + e.duration_ns() - s.end_ns) \
                <= 50_000, (name, s)


@pytest.mark.cuda
def test_engine_counters_read_lanes_and_allocator_on_card(profiled_engine):
    """``runner_lane_captures_total`` counts every lane the pool made and
    the lane the split's search captured at each count it measured and
    left; ``device_allocs_total`` grows by the allocator's own count when
    a fresh block must come from ``cudaMalloc``."""
    runner, eng, _, _ = profiled_engine
    snap = eng.snapshot()
    left = sum(not p.refused for p in runner.cores.balance or ()) - 1
    assert snap["counters"]["runner_lane_captures_total"]["series"] == {
        "": runner.lanes.count + max(left, 0)}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    stats = torch.cuda.memory_stats()["num_device_alloc"]
    block = torch.empty(3 << 30, dtype=torch.uint8, device="cuda")
    grown = torch.cuda.memory_stats()["num_device_alloc"] - stats
    after = eng.snapshot()
    assert grown >= 1
    assert readings.growth(snap, after, "device_allocs_total") >= grown
    del block


# --------------------------------------------------------------------------
# EfficientNet: the SE gate's kernels, silu and sigmoid, 5x5 depthwise
# --------------------------------------------------------------------------
def _b4_se_shapes():
    """Every distinct (map side, channels, SE channels) of B4's SE gates:
    190x190x48 through 12x12x2688."""
    from repro_torch.models.zoo import get_graph

    g = get_graph("efficientnet_b4")
    out = []
    for i in range(1, 33):
        d, r = g.layer(f"b{i}_dw"), g.layer(f"b{i}_se_reduce")
        shape = (d.H_out, d.C_o, r.C_o)
        if shape not in out:
            out.append(shape)
    return out


B4_SE = _b4_se_shapes()


def _se_operands(n, h, c, s, seed):
    x, w1, b1, w2, b2 = _arrays(seed, (n, h, h, c), (c, s), (s,), (s, c),
                                (c,))
    return x, w1 * (2 / c) ** 0.5, 0.1 * b1, w2 * (2 / s) ** 0.5, 0.1 * b2


@pytest.mark.cuda
@pytest.mark.parametrize("h,c,s", B4_SE, ids=[f"{h}x{h}x{c}-se{s}"
                                              for h, c, s in B4_SE])
def test_se_kernels_match_plain_at_b4_shapes_on_card(h, c, s, card):
    """The gate (cluster pool, two FCs) and the in-place scale at each of
    B4's SE shapes, batch 2, against the plain version at 1e-4; a second
    call gives the same bits."""
    from repro_torch.kernels.se.kernel import se_gate, se_scale
    from repro_torch.kernels.se.ref import se_gate_ref, se_scale_ref

    args = [a.to(card) for a in _se_operands(2, h, c, s, 21)]
    x = args[0]
    before = (se_gate.launches, se_scale.launches)
    gate = se_gate(*args)
    again = se_gate(*args)
    want = se_gate_ref(*args)
    scaled = se_scale(x.clone(), gate)
    torch.cuda.synchronize()
    assert (se_gate.launches, se_scale.launches) == (before[0] + 2,
                                                     before[1] + 1)
    assert torch.equal(gate, again)
    np.testing.assert_allclose(gate.cpu().numpy(), want.cpu().numpy(),
                               **TOL)
    assert torch.equal(scaled, se_scale_ref(x, gate))


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,c,s,offset", [
    (16, 190, 48, 12, 0), (16, 12, 2688, 112, 0), (3, 9, 70, 5, 0),
    (2, 13, 24, 6, 1)], ids=["b16-190", "b16-12", "ragged-C", "unaligned"])
def test_se_kernels_batch_ragged_and_unaligned_on_card(n, h, c, s, offset,
                                                       card):
    """Batch 16 at the largest and the widest map, a C that is not a
    multiple of 4 and a map 4 bytes off 16-byte alignment (the scalar
    paths): the plain version at 1e-4, the scale in place."""
    from repro_torch.kernels.se.kernel import se_gate, se_scale
    from repro_torch.kernels.se.ref import se_gate_ref, se_scale_ref

    x, w1, b1, w2, b2 = (a.to(card) for a in _se_operands(n, h, c, s, 22))
    if offset:
        buf = torch.empty(x.numel() + offset, device=card)
        buf[offset:] = x.flatten()
        x = buf[offset:].view(x.shape)
        assert x.data_ptr() % 16 != 0
    gate = se_gate(x, w1, b1, w2, b2)
    np.testing.assert_allclose(gate.cpu().numpy(),
                               se_gate_ref(x, w1, b1, w2, b2).cpu().numpy(),
                               **TOL)
    want = se_scale_ref(x, gate)
    ptr = x.data_ptr()
    out = se_scale(x, gate)
    torch.cuda.synchronize()
    assert out.data_ptr() == ptr and torch.equal(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("h,c,s", [B4_SE[0], B4_SE[-1]],
                         ids=["190x190x48", "12x12x2688"])
def test_se_gate_same_bits_on_two_streams_on_card(h, c, s, card):
    """The cluster's ranks meet in rank order: the gate on two other
    streams, on the c-core's and the p-core's partitions, has the bits
    of the first on the current stream."""
    from repro_torch.kernels.se.kernel import se_gate

    args = [a.to(card) for a in _se_operands(16, h, c, s, 23)]
    first = se_gate(*args)
    outs = []
    cores = DualCores(resolve_device(card))
    for stream in (torch.cuda.Stream(), torch.cuda.Stream(),
                   cores.streams["c"], cores.streams["p"]):
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            outs.append(se_gate(*args))
    torch.cuda.synchronize()
    assert all(torch.equal(first, o) for o in outs)


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["silu", "sigmoid"])
@pytest.mark.parametrize("call", [
    dict(kernel="matmul_bias_act", m=2 * 95 * 95, k=32, n=192),
    dict(kernel="matmul_bias_act", m=2 * 12 * 12, k=448, n=2688),
    dict(kernel="matmul_bias_act", m=2, k=1792, n=1000),
    dict(kernel="depthwise_conv2d", n=2, h=48, w=48, c=336, k=5, stride=1,
         pad=2),
    dict(kernel="depthwise_conv2d", n=2, h=190, w=190, c=48, k=3, stride=1,
         pad=1),
    dict(kernel="conv2d_implicit_gemm", n=2, h=380, w=380, ci=3, co=48, k=3,
         stride=2, pad=1)], ids=["K1-expand", "K1-wide", "K1-head",
                                 "K2-5x5", "K2-3x3", "K3-stem"])
def test_k1_k2_k3_silu_and_sigmoid_on_card(call, act, card):
    """K1, K2 and K3 with the new epilogues at B4's shapes, against the
    plain version at 1e-4."""
    call = dict(call, act=act)
    fn = WRAPPERS[{"matmul_bias_act": "K1", "depthwise_conv2d": "K2",
                   "conv2d_implicit_gemm": "K3"}[call["kernel"]]]
    case = chip_smoke.make_case(call, np.random.default_rng(24))
    got = case["kernel"]()
    want = case["plain"]()
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)


def _b4_dw5_calls():
    """Every distinct 5x5 depthwise conv of B4 at batch 16."""
    from repro_torch.models.zoo import get_graph

    seen = []
    for l in get_graph("efficientnet_b4").layers:
        call = dict(kernel="depthwise_conv2d", n=16, h=l.H, w=l.W, c=l.C_i,
                    k=l.K_h, stride=l.stride, pad=l.pad, act="silu")
        if l.op == "dwconv" and l.K_h == 5 and call not in seen:
            seen.append(call)
    return seen


B4_DW5 = _b4_dw5_calls()


@pytest.mark.cuda
@pytest.mark.parametrize("call", B4_DW5, ids=[
    f"{c['h']}x{c['w']}x{c['c']}-s{c['stride']}" for c in B4_DW5])
def test_k2_5x5_at_b4_shapes_on_card(call, card):
    """K2's generic window (no 5x5 specialisation) at every 5x5 shape of
    B4 at batch 16, strides 1 and 2, its planner's tiling within the
    shared memory a block may hold: the plain version at 1e-4, the same
    bits on a second call."""
    from repro_torch.kernels.depthwise.plan import MAX_SMEM, plan_k2

    plan = plan_k2(call["n"], call["h"], call["w"], call["c"], 5, 5,
                   call["stride"], call["pad"])
    assert plan.ow == 1 and plan.smem_bytes <= MAX_SMEM
    case = chip_smoke.make_case(call, np.random.default_rng(25))
    got = case["kernel"]()
    again = case["kernel"]()
    want = case["plain"]()
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_effnet_graphs_bit_equal_eager_and_near_the_reference_on_card(card):
    """A small EfficientNet (width 0.25, depth 0.5, 64 px) served on
    graphs on the split cores gives the eager engine's bits, counts two SE
    launches a block an image, and stays within 1e-3 of the plain
    reference (3xTF32 products against f32 ones)."""
    from repro_torch.kernels.se.kernel import se_gate, se_scale
    from repro_torch.models.cnn import init_params, params_from_numpy
    from repro_torch.models.efficientnet_ref import efficientnet_forward_ref
    from repro_torch.models.zoo import efficientnet_graph

    graph = efficientnet_graph(0.25, 0.5, 64, name="efficientnet_small")
    params = params_from_numpy(init_params(graph, 2), card)
    sched = build_schedule(graph, DUAL_BASELINE, BoardModel(), "balanced")
    fast = DualCoreRunner(graph, params, sched, device=card)
    eager = DualCoreRunner(graph, params, sched, device=card,
                           jit_groups=False)
    images = [t.to(card) for t in _arrays(8, *[(2, 64, 64, 3)] * 4)]
    want = stream_images(eager, images).outputs
    fast.run_sequential(images[:1])                    # warm-up and capture
    before = (se_gate.launches, se_scale.launches)
    got = stream_images(fast, images).outputs
    assert (se_gate.launches - before[0], se_scale.launches - before[1]) \
        == (4 * 10, 4 * 10)
    for x, a, b in zip(images, got, want):
        assert torch.equal(a, b)
        ref = efficientnet_forward_ref(params, x, 0.25, 0.5)
        assert float((a - ref).abs().max() / ref.pow(2).mean().sqrt()) < 1e-3
