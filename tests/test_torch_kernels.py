"""K1-K5: the port's plain versions against the reference Pallas kernels run
in interpret mode, on the same numpy inputs.

Tolerance rtol = atol = 1e-4, the reference's own for its kernel sweeps:
both sides are float32 and only the order of the sums differs.  On a CPU
tensor every wrapper runs its plain version and counts no launch; the CUDA
kernels are held against the plain versions in ``test_torch_cuda.py``.
"""
import dataclasses
import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv_gemm.kernel import (
    conv2d_implicit_gemm as ref_implicit_gemm,
    matmul_bias_act as ref_matmul)
from repro.kernels.attention.kernel import \
    decode_attention as ref_decode_attention
from repro.kernels.attention.kernel import \
    flash_attention as ref_flash_attention
from repro.kernels.depthwise.kernel import depthwise_conv2d as ref_depthwise
from repro.kernels.fused_block.kernel import fused_dw_pw_conv as ref_fused
from repro.kernels.fused_block.kernel import (
    fused_pw_dw_pw_conv as ref_fused_ir)
from repro_torch.kernels.attention import plan as aplan
from repro_torch.kernels.conv_gemm import ops as conv_ops
from repro_torch.kernels.conv_gemm import plan as gplan
from repro_torch.kernels.conv_gemm.kernel import (conv2d_implicit_gemm,
                                                  matmul_bias_act)
from repro_torch.kernels.depthwise import plan as dplan
from repro_torch.kernels.depthwise.kernel import depthwise_conv2d
from repro_torch.kernels.fused_block.kernel import (fused_dw_pw_conv,
                                                    fused_pw_dw_pw_conv)
from repro_torch.kernels.fused_block import plan as fplan
from repro_torch.kernels.fused_block.ops import fused_inverted_residual
from repro_torch.kernels.util import check_cuda_operands, find_nvcc
from repro_torch.models.zoo import get_graph

TOL = dict(rtol=1e-4, atol=1e-4)
ACTS = (None, "relu", "relu6")


def _arrays(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in shapes]


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _same(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **TOL)


# --------------------------------------------------------------------------
# K1 matmul_bias_act
# --------------------------------------------------------------------------
@pytest.mark.parametrize("m,k,n", [(64, 32, 48), (77, 13, 70)])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("act", ACTS)
def test_k1_matmul_matches_reference(m, k, n, bias, act):
    x, w, b = _arrays(1, (m, k), (k, n), (n,))
    b = b if bias else None
    before = matmul_bias_act.launches
    out = matmul_bias_act(_t(x), _t(w), _t(b), act=act)
    ref = ref_matmul(_j(x), _j(w), _j(b), act=act, interpret=True)
    _same(out, ref)
    assert matmul_bias_act.launches == before     # CPU: plain, no launch


# --------------------------------------------------------------------------
# K2 depthwise_conv2d
# --------------------------------------------------------------------------
@pytest.mark.parametrize("h,w,c,k,stride", [
    (12, 12, 16, 3, 1), (13, 11, 24, 3, 2), (9, 9, 8, 5, 1)])
@pytest.mark.parametrize("bias,act", [(True, "relu6"), (False, None),
                                      (True, "relu")])
def test_k2_depthwise_matches_reference(h, w, c, k, stride, bias, act):
    pad = k // 2
    x, wt, b = _arrays(2, (2, h, w, c), (k, k, c), (c,))
    b = b if bias else None
    out = depthwise_conv2d(_t(x), _t(wt), _t(b), stride=stride, pad=pad,
                           act=act)
    ref = ref_depthwise(_j(x), _j(wt), _j(b), stride=stride, pad=pad,
                        act=act, interpret=True)
    _same(out, ref)


# --------------------------------------------------------------------------
# K3 conv2d_implicit_gemm
# --------------------------------------------------------------------------
@pytest.mark.parametrize("h,w,ci,co,stride,pad", [
    (16, 16, 3, 32, 2, 1),       # the MobileNet stem, at 16 px
    (10, 10, 8, 24, 1, 1),       # a SqueezeNet e3x3
    (15, 13, 5, 20, 2, 0)])      # ragged, no pad
@pytest.mark.parametrize("bias,act", [(True, "relu"), (False, None),
                                      (True, "relu6")])
def test_k3_implicit_gemm_matches_reference(h, w, ci, co, stride, pad, bias,
                                            act):
    x, wt, b = _arrays(3, (2, h, w, ci), (3, 3, ci, co), (co,), scale=0.5)
    b = b if bias else None
    out = conv2d_implicit_gemm(_t(x), _t(wt), _t(b), stride=stride,
                               pad=pad, act=act)
    ref = ref_implicit_gemm(_j(x), _j(wt), _j(b), stride=stride, pad=pad,
                            act=act, interpret=True)
    _same(out, ref)


# --------------------------------------------------------------------------
# K4 fused_dw_pw_conv
# --------------------------------------------------------------------------
@pytest.mark.parametrize("h,w,c,co,stride", [
    (12, 12, 16, 24, 1), (13, 11, 24, 40, 2)])
@pytest.mark.parametrize("bias,res,dw_act,pw_act", [
    (True, False, "relu6", None),
    (True, True, "relu6", None),
    (False, False, "relu", "relu"),
    (False, True, None, "relu6")])
def test_k4_fused_dw_pw_matches_reference(h, w, c, co, stride, bias, res,
                                          dw_act, pw_act):
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    x, dw_w, dw_b, pw_w, pw_b, r = _arrays(
        4, (2, h, w, c), (3, 3, c), (c,), (c, co), (co,), (2, ho, wo, co),
        scale=0.5)
    dw_b, pw_b = (dw_b, pw_b) if bias else (None, None)
    r = r if res else None
    out = fused_dw_pw_conv(_t(x), _t(dw_w), _t(dw_b), _t(pw_w), _t(pw_b),
                           _t(r), stride=stride, pad=1, dw_act=dw_act,
                           pw_act=pw_act)
    ref = ref_fused(_j(x), _j(dw_w), _j(dw_b), _j(pw_w), _j(pw_b), _j(r),
                    stride=stride, pad=1, dw_act=dw_act, pw_act=pw_act,
                    interpret=True)
    _same(out, ref)


# --------------------------------------------------------------------------
# K5 fused_pw_dw_pw_conv
# --------------------------------------------------------------------------
K5_ACTS = [("relu6", "relu6", None), (None, "relu", "relu6"),
           ("relu", None, "relu")]


def _k5_inputs(seed, h, w, ci, cm, co, stride, res, biases):
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    x, ew, eb, dw, db, pw, pb, r = _arrays(
        seed, (2, h, w, ci), (ci, cm), (cm,), (3, 3, cm), (cm,), (cm, co),
        (co,), (2, ho, wo, co), scale=0.5)
    if biases == "none":
        eb = db = pb = None
    elif biases == "exp_only":      # the zero-padding trap: the pad of the
        db = pb = None              # expanded map is 0, not act(exp_b)
        eb = np.abs(eb) + 0.5
    return x, ew, eb, dw, db, pw, pb, (r if res else None)


@pytest.mark.parametrize("h,w,ci,cm,co,stride,res", [
    (12, 12, 16, 48, 24, 1, False),   # a MobileNet v2 block, narrow
    (12, 12, 16, 48, 16, 1, True),    # ... with its residual
    (13, 11, 8, 40, 20, 2, False),    # stride 2, odd sizes
    (9, 10, 12, 37, 70, 1, False),    # ragged Cm and Co
    (9, 10, 12, 37, 12, 1, True)])    # ragged Cm, residual
@pytest.mark.parametrize("biases", ["all", "none", "exp_only"])
@pytest.mark.parametrize("acts", K5_ACTS)
def test_k5_fused_inverted_residual_matches_reference(h, w, ci, cm, co,
                                                      stride, res, biases,
                                                      acts):
    exp_act, dw_act, proj_act = acts
    args = _k5_inputs(5, h, w, ci, cm, co, stride, res, biases)
    kw = dict(stride=stride, pad=1, exp_act=exp_act, dw_act=dw_act,
              proj_act=proj_act)
    before = fused_pw_dw_pw_conv.launches
    out = fused_inverted_residual(*(_t(a) for a in args), **kw)
    ref = ref_fused_ir(*(_j(a) for a in args), **kw, interpret=True)
    _same(out, ref)
    assert fused_pw_dw_pw_conv.launches == before  # CPU: plain, no launch


def test_k5_takes_4d_and_2d_pointwise_weights_alike():
    x, ew, eb, dw, db, pw, pb, r = (
        _t(a) for a in _k5_inputs(6, 10, 10, 8, 24, 8, 1, True, "all"))
    kw = dict(stride=1, pad=1, exp_act="relu6", dw_act="relu6",
              proj_act=None)
    a = fused_inverted_residual(x, ew, eb, dw, db, pw, pb, r, **kw)
    b = fused_inverted_residual(x, ew.reshape(1, 1, 8, 24), eb, dw, db,
                                pw.reshape(1, 1, 24, 8), pb, r, **kw)
    assert torch.equal(a, b)


def test_k5_wrapper_rejects_bad_shapes():
    x, ew, eb, dw, db, pw, pb, _ = (
        _t(a) for a in _k5_inputs(7, 8, 8, 8, 16, 8, 1, False, "all"))
    with pytest.raises(ValueError, match="fused_pw_dw_pw_conv"):
        fused_pw_dw_pw_conv(x, ew, eb, dw[..., :8], db, pw, pb)
    with pytest.raises(ValueError, match="residual"):
        fused_pw_dw_pw_conv(x, ew, eb, dw, db, pw, pb,
                            torch.zeros((2, 4, 4, 8)))


# --------------------------------------------------------------------------
# K4 and K5 planners
# --------------------------------------------------------------------------
def _planner_cases():
    """Every distinct K4 and K5 call of the four CNN paths (batch 2, 224
    px, as ``chip_smoke.py`` derives them), its edge cases, and the shapes
    of the interpret-mode tests above."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    calls = [c for c in [*chip_smoke.cnn_path_calls(),
                         *chip_smoke.edge_calls()]
             if c["kernel"] in chip_smoke.FUSED_KERNELS]
    for h, w, c, co, stride in [(12, 12, 16, 24, 1), (13, 11, 24, 40, 2)]:
        calls.append(dict(kernel="fused_dw_pw_conv", n=2, h=h, w=w, c=c,
                          co=co, k=3, stride=stride, pad=1))
    for h, w, ci, cm, co, stride, _res in [
            (12, 12, 16, 48, 24, 1, False), (12, 12, 16, 48, 16, 1, True),
            (13, 11, 8, 40, 20, 2, False), (9, 10, 12, 37, 70, 1, False)]:
        calls.append(dict(kernel="fused_pw_dw_pw_conv", n=2, h=h, w=w,
                          ci=ci, cm=cm, co=co, k=3, stride=stride, pad=1))
    keys = ("kernel", "n", "h", "w", "c", "ci", "cm", "co", "k", "stride",
            "pad")
    seen = {}
    for c in calls:
        c = {k: c[k] for k in keys if k in c}
        seen.setdefault(json.dumps(c, sort_keys=True), c)
    return list(seen.values())


PLANNER_CASES = _planner_cases()


@pytest.mark.parametrize("call", PLANNER_CASES, ids=[
    "-".join(str(v) for v in c.values())[6:] for c in PLANNER_CASES])
def test_fused_planner_covers_the_call_once(call):
    """``plan_k4``/``plan_k5`` at every K4/K5 call of the CNN paths: the
    pixel tiles cover the output once, the channel split covers C (K5: Cm)
    once in rank order, the shared memory and the cluster fit an H100, and
    the grid fills the 132 SMs wherever 4x4 tiles x cluster x images can."""
    c = call
    k4 = c["kernel"] == "fused_dw_pw_conv"
    if k4:
        p = fplan.plan_k4(c["n"], c["h"], c["w"], c["c"], c["co"], c["k"],
                          c["stride"], c["pad"])
        split_c = c["c"]
        floats = fplan.k4_smem_floats(p.th, p.tw, c["co"], c["k"], c["k"],
                                      c["stride"], p.stages)
    else:
        p = fplan.plan_k5(c["n"], c["h"], c["w"], c["ci"], c["cm"], c["co"],
                          c["k"], c["stride"], c["pad"])
        split_c = c["cm"]
        floats = fplan.k5_smem_floats(p.th, p.tw, c["co"], c["k"], c["k"],
                                      c["stride"], p.stages, p.kc, p.group)
    ho, wo = fplan.out_size(c["h"], c["w"], c["k"], c["k"], c["stride"],
                            c["pad"])
    cover = np.zeros((ho, wo), np.int64)
    for t in range(p.tiles_h * p.tiles_w):      # the kernels' tile walk
        oh0, ow0 = (t // p.tiles_w) * p.th, (t % p.tiles_w) * p.tw
        assert oh0 < ho and ow0 < wo            # no tile outside the map
        cover[oh0:oh0 + p.th, ow0:ow0 + p.tw] += 1
    assert (cover == 1).all()
    assert p.blocks == p.cluster * p.tiles_h * p.tiles_w * c["n"]
    splits = fplan.channel_splits(split_c, p.cluster)
    assert len(splits) == p.cluster
    edge = 0
    for lo, hi in splits:                       # rank order, no gap
        assert lo == edge and lo < hi and lo % fplan.CK == 0
        edge = hi
    assert edge == split_c
    assert p.smem_bytes == 4 * floats <= 232_448
    assert 2 <= p.stages <= 4
    assert 1 <= p.cluster <= 16        # above 8 the launch opts in
    assert p.th * p.tw <= 64
    if not k4:                  # a step and pass the C side has compiled
        hh, hw = fplan._halo(p.th, p.tw, c["k"], c["k"], c["stride"])
        mte = -(-hh * hw // 16)
        assert p.group == 1 or mte <= 4
        assert p.kc == 32 or (p.kc == 64 and mte <= 8
                              and (mte > 4 or p.group == 4))
    reach = (c["n"] * -(-ho // 4) * -(-wo // 4)
             * min(16, -(-split_c // fplan.CK)))
    if reach >= 132:
        assert p.blocks >= 132


def test_fused_planner_is_deterministic_and_refuses_what_cannot_fit():
    assert fplan.plan_k4(2, 14, 14, 512, 512, 3, 1, 1) == \
        fplan._plan("k4", 2, 14, 14, 0, 512, 512, 3, 3, 1)
    with pytest.raises(ValueError, match="no tiling fits"):
        fplan.plan_k4(1, 8, 8, 16, 4096, 3, 1, 1)   # Co past the registers


# --------------------------------------------------------------------------
# K1 and K2 planners
# --------------------------------------------------------------------------
def _k1k2_cases(kernel):
    """Every distinct call of ``kernel`` (K1 or K2) on the four CNN paths
    (batch 2, 224 px, as ``chip_smoke.py`` derives them), its edge cases,
    and the shapes of the interpret-mode tests above."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    calls = [c for c in [*chip_smoke.cnn_path_calls(),
                         *chip_smoke.edge_calls()] if c["kernel"] == kernel]
    if kernel == "matmul_bias_act":
        calls += [dict(m=64, k=32, n=48), dict(m=77, k=13, n=70)]
        keys = ("m", "k", "n")
    else:
        calls += [dict(n=2, h=h, w=w, c=c, k=k, stride=s, pad=k // 2)
                  for h, w, c, k, s in [(12, 12, 16, 3, 1), (13, 11, 24, 3, 2),
                                        (9, 9, 8, 5, 1)]]
        keys = ("n", "h", "w", "c", "k", "stride", "pad")
    seen = {}
    for c in calls:
        c = {k: c[k] for k in keys}
        seen.setdefault(json.dumps(c, sort_keys=True), c)
    return list(seen.values())


K1_CASES = _k1k2_cases("matmul_bias_act")
K2_CASES = _k1k2_cases("depthwise_conv2d")


@pytest.mark.parametrize("call", K1_CASES, ids=[
    "{m}x{k}x{n}".format(**c) for c in K1_CASES])
def test_k1_planner_covers_the_call_once(call):
    """``plan_k1`` at every K1 call of the CNN paths: the output tiles
    cover M x N once, the K split covers K once in rank order, the warps
    cover the tile with a compiled layout, the shared memory and the
    cluster fit an H100, and the grid fills the 132 SMs wherever a tiling
    the planner offers does."""
    m, k, n = call["m"], call["k"], call["n"]
    p = gplan.plan_k1(m, k, n)
    cover = np.zeros((m, n), np.int64)
    for tm in range(p.tiles_m):                 # the kernel's grid
        for tn in range(p.tiles_n):
            assert tm * p.bm < m and tn * p.bn < n
            cover[tm * p.bm:(tm + 1) * p.bm, tn * p.bn:(tn + 1) * p.bn] += 1
    assert (cover == 1).all()
    assert p.blocks == p.cluster * p.tiles_m * p.tiles_n
    edge = 0
    for lo, hi in gplan.k_splits(k, p.bk, p.cluster):   # rank order, no gap
        assert lo == edge and lo < hi and lo % p.bk == 0
        edge = hi
    assert edge == k
    assert (p.mi, p.nj) in gplan.COMPILED
    assert p.wm * p.mi * 16 == p.bm and 8 // p.wm * p.nj * 8 >= p.bn
    assert p.bn <= 128 and (p.bn in gplan.BNS or p.bn == n)
    assert p.smem_bytes == 4 * gplan.k1_smem_floats(p.bm, p.bn, p.bk,
                                                    p.stages) <= 232_448
    assert 2 <= p.stages <= 4 and 1 <= p.cluster <= 16
    if max(q.blocks for _k, q in gplan.candidates(m, k, n)) >= 132:
        assert p.blocks >= 132


@pytest.mark.parametrize("call", K2_CASES, ids=[
    "{n}x{h}x{w}x{c}-k{k}s{stride}".format(**c) for c in K2_CASES])
def test_k2_planner_covers_the_call_once(call):
    """``plan_k2`` at every K2 call of the CNN paths: the pixel tiles cover
    the output once, the channel blocks cover C once, a block's threads
    cover its tile's outputs, the threads and shared memory fit, the
    outputs a thread are compiled for the window, and the grid fills the
    132 SMs wherever a tiling the planner offers does."""
    c = call
    p = dplan.plan_k2(c["n"], c["h"], c["w"], c["c"], c["k"], c["k"],
                      c["stride"], c["pad"])
    ho = (c["h"] + 2 * c["pad"] - c["k"]) // c["stride"] + 1
    wo = (c["w"] + 2 * c["pad"] - c["k"]) // c["stride"] + 1
    cover = np.zeros((ho, wo), np.int64)
    for t in range(p.tiles_h * p.tiles_w):      # the kernel's tile walk
        oh0, ow0 = (t // p.tiles_w) * p.th, (t % p.tiles_w) * p.tw
        assert oh0 < ho and ow0 < wo
        cover[oh0:oh0 + p.th, ow0:ow0 + p.tw] += 1
    assert (cover == 1).all()
    chans = np.zeros(c["c"], np.int64)
    for cb in range(p.cblocks):
        assert cb * 4 * p.cq < c["c"]
        chans[cb * 4 * p.cq:(cb + 1) * 4 * p.cq] += 1
    assert (chans == 1).all()
    strips = -(-p.tw // p.ow)
    assert p.threads == p.cq * p.th * strips <= 256
    assert strips * p.ow >= p.tw
    assert p.ow in dplan.compiled_ows(c["k"], c["k"], c["stride"])
    assert p.blocks == p.tiles_h * p.tiles_w * p.cblocks * c["n"]
    assert p.smem_bytes == 4 * dplan.k2_smem_floats(
        p.th, p.tw, p.cq, p.ow, c["k"], c["k"], c["stride"]) <= 232_448
    cands = dplan.candidates(c["n"], ho, wo, c["c"], c["k"], c["k"],
                             c["stride"])
    if max(q.blocks for _k, q in cands) >= 132:
        assert p.blocks >= 132


def test_k1_k2_planners_are_deterministic_and_refuse_what_cannot_fit():
    assert gplan.plan_k1(392, 512, 1000) == min(
        gplan.candidates(392, 512, 1000), key=lambda kp: kp[0])[1]
    assert dplan.plan_k2(2, 14, 14, 512, 3, 3, 1, 1) == min(
        dplan.candidates(2, 14, 14, 512, 3, 3, 1), key=lambda kp: kp[0])[1]
    with pytest.raises(ValueError, match="no tiling fits"):
        gplan.plan_k1(1, 1, 9_000_000)          # past the grid's 65535 tiles
    with pytest.raises(ValueError, match="empty"):
        gplan.plan_k1(0, 16, 16)
    with pytest.raises(ValueError, match="no tiling fits"):
        dplan.plan_k2(1, 200, 200, 4, 101, 101, 1, 50)  # window past smem


# --------------------------------------------------------------------------
# K3 and K7 decode planners
# --------------------------------------------------------------------------
def _k3_cases():
    """Every distinct K3 call of the CNN paths and edge cases, and the
    shapes of the interpret-mode tests above."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    keys = ("n", "h", "w", "ci", "co", "k", "stride", "pad")
    calls = [c for c in [*chip_smoke.cnn_path_calls(),
                         *chip_smoke.edge_calls()]
             if c["kernel"] == "conv2d_implicit_gemm"]
    calls += [dict(n=2, h=h, w=w, ci=ci, co=co, k=3, stride=s, pad=p)
              for h, w, ci, co, s, p in [(16, 16, 3, 32, 2, 1),
                                         (10, 10, 8, 24, 1, 1),
                                         (15, 13, 5, 20, 2, 0)]]
    seen = {}
    for c in calls:
        c = {k: c[k] for k in keys}
        seen.setdefault(json.dumps(c, sort_keys=True), c)
    return list(seen.values())


K3_CASES = _k3_cases()


@pytest.mark.parametrize("call", K3_CASES, ids=[
    "{n}x{h}x{w}x{ci}-{co}s{stride}".format(**c) for c in K3_CASES])
def test_k3_planner_covers_the_call_once(call):
    """``plan_k3`` at every K3 call: the tiles cover the N*Ho*Wo x Co output
    once, the ranks' k-steps cover K = 9 Ci once in rank order, the k
    table holds the busiest rank's entries, the shared memory and the
    cluster fit, and the layout and k-step are compiled."""
    c = call
    vec = c["ci"] % 4 == 0
    p = gplan.plan_k3(c["n"], c["h"], c["w"], c["ci"], c["co"], c["k"],
                      c["k"], c["stride"], c["pad"], vec)
    ho = (c["h"] + 2 * c["pad"] - c["k"]) // c["stride"] + 1
    wo = (c["w"] + 2 * c["pad"] - c["k"]) // c["stride"] + 1
    m, k, n = c["n"] * ho * wo, c["k"] * c["k"] * c["ci"], c["co"]
    cover = np.zeros((m, n), np.int64)
    for tm in range(p.tiles_m):
        for tn in range(p.tiles_n):
            cover[tm * p.bm:(tm + 1) * p.bm, tn * p.bn:(tn + 1) * p.bn] += 1
    assert (cover == 1).all()
    edge, most = 0, 0
    for lo, hi in gplan.k_splits(k, p.bk, p.cluster):
        assert lo == edge and lo < hi and lo % p.bk == 0
        most = max(most, -(-(hi - lo) // p.bk) * p.bk)
        edge = hi
    assert edge == k
    assert gplan.k3_entries(k, p.bk, p.cluster, vec) * (4 if vec else 1) \
        >= most
    assert p.bk in gplan.K3_BKS[vec] and (p.mi, p.nj) in gplan.COMPILED
    assert p.smem_bytes == 4 * gplan.k3_smem_floats(
        p.bm, p.bn, p.bk, p.stages,
        gplan.k3_entries(k, p.bk, p.cluster, vec)) <= 232_448
    assert 1 <= p.cluster <= 16 and p.blocks == p.cluster * p.tiles_m \
        * p.tiles_n


DECODE_CASES = [(16, 14, 2, sk, 64) for sk in (513, 544, 575)] + [
    (16, 40, 8, 576, 128), (16, 48, 1, 576, 128), (16, 96, 8, 576, 128),
    (4, 14, 2, 576, 64), (3, 14, 2, 100, 8), (1, 14, 2, 0, 64),
    (2, 6, 1, 9000, 16), (16, 32, 32, 576, 80), (4, 32, 2, 300, 80),
    (2, 12, 12, 1500, 64)]


@pytest.mark.parametrize("call", DECODE_CASES, ids=[
    "b{}-hq{}-hkv{}-sk{}-d{}".format(*c) for c in DECODE_CASES])
def test_decode_planner_covers_every_key_once(call):
    """``plan_decode``: the ranks' key runs cover the cache once, in rank
    order and in whole 32-key tiles; the tensor cores take the groups
    above 8; the slots, cluster and shared memory fit an H100."""
    b, hq, hkv, sk, d = call
    p = aplan.plan_decode(*call)
    edge = 0
    for lo, hi in aplan.key_splits(sk, p.cluster):
        assert lo == edge and lo % aplan.TK == 0 and hi - lo <= p.keys
        edge = max(edge, hi)
    assert edge == sk
    assert p.tc == (hq // hkv > aplan.GM)
    assert 1 <= p.cluster <= 16 and p.blocks == p.cluster * b * hkv
    assert (2 <= p.slots <= 4) if p.tc else (1 <= p.slots <= 8)
    assert p.smem_bytes == 4 * aplan.decode_smem_floats(
        hq // hkv, d, p.slots, p.cluster, p.tc) <= 232_448


def test_k3_decode_planners_are_deterministic_and_refuse_what_cannot_fit():
    assert gplan.plan_k3(2, 14, 14, 64, 256, 3, 3, 1, 1, True) == min(
        gplan.k3_candidates(2, 14, 14, 64, 256, 3, 3, 1, 1, True),
        key=lambda kp: kp[0])[1]
    assert aplan.plan_decode(16, 14, 2, 575, 64) == min(
        aplan.candidates(16, 14, 2, 575, 64), key=lambda kp: kp[0])[1]
    with pytest.raises(ValueError, match="Ci % 4"):
        gplan.plan_k3(2, 14, 14, 3, 32, 3, 3, 2, 1, True)
    with pytest.raises(ValueError, match="empty"):
        gplan.plan_k3(2, 2, 2, 3, 32, 5, 5, 1, 0, False)
    with pytest.raises(ValueError, match="no tiling fits"):
        gplan.plan_k3(1, 3, 3, 4, 9_000_000, 3, 3, 1, 1, True)
    for bad in [(1, 49, 1, 64, 128), (1, 14, 2, 64, 256), (1, 14, 2, 64, 12),
                (1, 32, 2, 64, 4), (1, 14, 2, 64, 20), (1, 14, 2, 64, 136)]:
        with pytest.raises(ValueError, match="past the kernel"):
            aplan.plan_decode(*bad)


# --------------------------------------------------------------------------
# K7 flash planner
# --------------------------------------------------------------------------
# (b, hq, hkv, sq, sk, d, causal, q_offset, sk_valid): the Qwen2-0.5B
# prefill, the other dense configs' geometry, a chunk against a cache, rows
# past a block's, a padding mask, one query row, narrow and odd heads
FLASH_CASES = [
    (2, 14, 2, 512, 512, 64, True, 0, None),
    (2, 40, 8, 512, 512, 128, True, 0, None),
    (2, 48, 1, 512, 512, 128, True, 0, None),
    (2, 96, 8, 512, 512, 128, True, 0, None),
    (2, 14, 2, 128, 512, 64, True, 384, None),
    (2, 14, 2, 130, 130, 64, True, 0, None),
    (1, 6, 3, 40, 100, 64, False, 0, 71),
    (2, 14, 2, 1, 100, 64, False, 0, None),
    (2, 4, 2, 33, 33, 8, True, 0, None),
    (1, 4, 1, 45, 60, 37, True, 15, None),
]
FLASH_IDS = ["b{}-hq{}-hkv{}-sq{}-sk{}-d{}-c{:d}-off{}-v{}".format(*c)
             for c in FLASH_CASES]


def _flash_costs(plan, call):
    """Each block's serial key tiles, in launch order, under ``plan``."""
    b, hq, _hkv, sq, sk, _d, causal, off, valid = call
    return [-(-aplan.flash_tile_keys(t, plan.rows, sq, sk, causal, off,
                                     valid) // (plan.bk * plan.kv_split))
            for _b, _h, t in aplan.flash_items(plan, b, hq)]


@pytest.mark.parametrize("call", FLASH_CASES, ids=FLASH_IDS)
def test_flash_planner_covers_every_item_once(call):
    """Under every plan ``plan_flash`` weighs, the blocks take each
    (batch, head, q tile) exactly once, and the q tiles cover Sq."""
    b, hq, hkv, sq, sk, d, causal, off, valid = call
    for _key, p in aplan.flash_candidates(*call):
        seen = aplan.flash_items(p, b, hq)
        assert len(seen) == len(set(seen)) == b * hq * p.q_tiles == p.blocks
        assert set(seen) == {(i, h, t) for i in range(b) for h in range(hq)
                             for t in range(p.q_tiles)}
        assert (p.q_tiles - 1) * p.rows < sq <= p.q_tiles * p.rows


@pytest.mark.parametrize("call", FLASH_CASES, ids=FLASH_IDS)
def test_flash_planner_orders_heaviest_first(call):
    """Under every plan the blocks' serial key tiles never grow in launch
    order, and a key split halves the heaviest block's (rounding up)."""
    for _key, p in aplan.flash_candidates(*call):
        costs = _flash_costs(p, call)
        assert costs == sorted(costs, reverse=True)
        whole = dataclasses.replace(p, kv_split=1)
        assert costs[0] == -(-_flash_costs(whole, call)[0] // p.kv_split)


@pytest.mark.parametrize("call", FLASH_CASES, ids=FLASH_IDS)
def test_flash_planner_fits_an_h100(call):
    """Every plan's shared memory is the kernel's carve-up and fits 227
    KB, at least one block fits an SM, the grid fits its x axis, and a
    key split keeps the block at 8 warps."""
    for _key, p in aplan.flash_candidates(*call):
        assert p.smem_bytes == 4 * aplan.flash_smem_floats(
            call[5], p.warps, p.ring, p.kv_split) <= 232_448
        assert p.per_sm >= 1 and p.blocks <= 2 ** 31 - 1
        assert p.warps in aplan.FLASH_WARPS and p.ring in aplan.FLASH_RINGS
        assert p.kv_split in (1, 2) and p.warps * p.kv_split <= 8
        assert p.bk == (32 if call[5] > 64 else 64)


def test_flash_planner_is_deterministic_and_refuses_what_the_kernel_does():
    call = (2, 14, 2, 512, 512, 64, True, 0, None)
    assert aplan.plan_flash(*call) == min(aplan.flash_candidates(*call),
                                          key=lambda kp: kp[0])[1]
    assert aplan.plan_flash(*call) == aplan.plan_flash.__wrapped__(*call)
    for bad in [(1, 4, 2, 8, 8, 129), (1, 4, 2, 8, 8, 0), (1, 5, 2, 8, 8, 64),
                (1, 4, 2, 0, 8, 64), (1, 4, 2, 8, -1, 64)]:
        with pytest.raises(ValueError, match="flash"):
            aplan.plan_flash(*bad)
    with pytest.raises(ValueError, match="q_offset"):
        aplan.plan_flash(1, 4, 2, 8, 8, 64, True, -1)


# --------------------------------------------------------------------------
# The backward kernels' splits: K7 flash's planner and K6's row blocks
# --------------------------------------------------------------------------
def _train_bwd_cases(kind: str) -> list[dict]:
    """The training path's ``kind`` call and its edges in ``chip_smoke.py``
    (``train_calls``, ``train_edge_calls``)."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    return [c for c in [*chip_smoke.train_calls(),
                        *chip_smoke.train_edge_calls()]
            if c["kernel"] == kind]


FLASH_BWD_CASES = [tuple(c[k] for k in ("b", "hq", "hkv", "sq", "sk", "d",
                                        "causal", "q_offset", "sk_valid"))
                   for c in _train_bwd_cases("flash_attention_bwd")] + [
    (2, 14, 2, 4096, 4096, 64, True, 0, None),
    (1, 48, 1, 300, 300, 128, True, 0, None),
    (2, 14, 2, 100, 612, 64, True, 512, None),
]
FLASH_BWD_IDS = ["b{}-hq{}-hkv{}-sq{}-sk{}-d{}-c{:d}-off{}-v{}".format(*c)
                 for c in FLASH_BWD_CASES]
RMS_BWD_CASES = [(c["rows"], c["d"])
                 for c in _train_bwd_cases("rmsnorm_bwd")] + [(16, 896),
                                                               (4097, 64)]


@pytest.mark.parametrize("call", FLASH_BWD_CASES, ids=FLASH_BWD_IDS)
def test_flash_bwd_planner_covers_every_item_once(call):
    """Under every plan ``plan_flash_bwd`` weighs, the dK/dV blocks take
    each (batch, KV head, key tile, query head) exactly once (a pair's two
    key tiles in one block, a cluster's heads split between its ranks),
    the key tiles cover Sk, and the dQ blocks take each (batch, head, q
    tile) exactly once."""
    b, hq, hkv, sq, sk, d = call[:6]
    g = hq // hkv
    for _key, p in aplan.flash_bwd_candidates(*call):
        items = [it for blk in aplan.flash_bwd_kv_items(p, b, hkv, g)
                 for it in blk]
        assert len(items) == len(set(items)) == b * hq * p.key_tiles
        assert set(items) == {(i, hk, kt, hk * g + h) for i in range(b)
                              for hk in range(hkv)
                              for kt in range(p.key_tiles)
                              for h in range(g)}
        assert (p.key_tiles - 1) * p.kv_keys < sk <= p.key_tiles * p.kv_keys
        assert p.kv_blocks == p.kv_items * p.cluster
        seen = aplan.flash_bwd_q_items(p, b, hq)
        assert len(seen) == len(set(seen)) == b * hq * p.q_tiles == p.q_blocks
        assert set(seen) == {(i, h, t) for i in range(b) for h in range(hq)
                             for t in range(p.q_tiles)}
        assert (p.q_tiles - 1) * p.q_rows < sq <= p.q_tiles * p.q_rows


@pytest.mark.parametrize("call", FLASH_BWD_CASES, ids=FLASH_BWD_IDS)
def test_flash_bwd_planner_balances_no_worse_than_plain_order(call):
    """The chosen plan's dK/dV blocks, placed by the planner's model, end
    no later than the same key tile's blocks in plain order (a block a
    (batch, KV head, key tile) with its whole group, the order before
    the planner), and its heaviest block is no heavier; the dQ blocks run
    heaviest first."""
    b, hq, hkv = call[:3]
    p = aplan.plan_flash_bwd(*call)
    plain = aplan.flash_bwd_plain_costs(p, *call[:5], *call[6:])
    mine = aplan.flash_bwd_kv_costs(p, *call[:5], *call[6:])
    assert p.kv_makespan == aplan._makespan(mine, p.kv_per_sm, p.kv_warps)
    assert p.kv_makespan <= aplan._makespan(plain, p.kv_per_sm, p.kv_warps)
    assert max(mine, default=0) <= max(plain, default=0)
    qt = [t for _b, _h, t in aplan.flash_bwd_q_items(p, b, hq)]
    assert qt == sorted(qt, reverse=True)


def test_flash_bwd_planner_evens_out_the_training_call():
    """At the training path's call (B 8, Hq 14, Hkv 2, S 512, D 64,
    causal) the model puts the dK/dV pass at most 3/4 of plain order's
    makespan, with at least as many blocks as the card has SMs."""
    call = FLASH_BWD_CASES[0]
    assert call == (8, 14, 2, 512, 512, 64, True, 0, None)
    p = aplan.plan_flash_bwd(*call)
    plain = aplan.flash_bwd_plain_costs(p, *call[:5], *call[6:])
    assert p.kv_makespan <= 0.75 * aplan._makespan(plain, p.kv_per_sm,
                                                   p.kv_warps)
    assert p.kv_blocks >= aplan.SMS and p.q_blocks >= aplan.SMS


@pytest.mark.parametrize("call", FLASH_BWD_CASES, ids=FLASH_BWD_IDS)
def test_flash_bwd_planner_fits_an_h100(call):
    """Every plan's shared memory is each kernel's carve-up and fits 227
    KB, at least one block of either pass fits an SM, the grids fit
    (items over y and z, ranks over x), and a cluster is at most 8 ranks
    and no more than the group's heads."""
    d, g = call[5], call[1] // call[2]
    for _key, p in aplan.flash_bwd_candidates(*call):
        assert p.q_smem_bytes == 4 * aplan.flash_bwd_q_smem_floats(
            d, p.q_warps, p.q_ring) <= 232_448
        assert p.kv_smem_bytes == 4 * aplan.flash_bwd_kv_smem_floats(
            d, p.kv_warps, p.kv_ring) <= 232_448
        assert p.q_per_sm >= 1 and p.kv_per_sm >= 1
        assert p.q_blocks <= 2 ** 31 - 1 and p.kv_items <= 65535 ** 2
        assert 1 <= p.cluster <= min(g, 8)
        assert p.q_warps in aplan.BWD_Q_WARPS
        assert p.kv_warps in aplan.BWD_KV_WARPS
        assert p.q_ring in aplan.BWD_RINGS and p.kv_ring in aplan.BWD_RINGS
        assert p.q_bk == (32 if d > 64 else 64) and p.kv_bq == 32
        assert not p.pair or p.key_tiles >= 3


def test_flash_bwd_planner_is_deterministic_and_refuses_what_the_kernel_does():
    call = (8, 14, 2, 512, 512, 64, True, 0, None)
    assert aplan.plan_flash_bwd(*call) == min(
        aplan.flash_bwd_candidates(*call), key=lambda kp: kp[0])[1]
    assert aplan.plan_flash_bwd(*call) == aplan.plan_flash_bwd.__wrapped__(
        *call)
    assert aplan.flash_bwd_candidates(*call) == \
        aplan.flash_bwd_candidates(*call)
    for bad in [(1, 4, 2, 8, 8, 129), (1, 4, 2, 8, 8, 0), (1, 5, 2, 8, 8, 64),
                (1, 4, 2, 0, 8, 64), (1, 4, 2, 8, -1, 64)]:
        with pytest.raises(ValueError, match="flash backward"):
            aplan.plan_flash_bwd(*bad)
    with pytest.raises(ValueError, match="q_offset"):
        aplan.plan_flash_bwd(1, 4, 2, 8, 8, 64, True, -1)


@pytest.mark.parametrize("rows,d", RMS_BWD_CASES,
                         ids=[f"rows{r}-d{d}" for r, d in RMS_BWD_CASES])
def test_rmsnorm_bwd_split_covers_every_row_and_partial_once(rows, d):
    """K6's backward: the rows pass's blocks (``bwd_blocks``; a warp a row
    where d % 4 == 0 and d <= 1024) take every row exactly once, none of
    them empty, at most one block an SM of the H100 on the warp-per-row
    path; the dw pass takes each (column, block partial) exactly once,
    every warp's run contiguous and in order."""
    from repro_torch.kernels.rmsnorm import kernel as k6
    blocks = k6.bwd_blocks(rows, d)
    split = k6.bwd_row_split(rows, d)
    assert len(split) == blocks <= min(rows, 132 if k6.bwd_vec(d) else 264)
    flat = [r for blk in split for warp in blk for r in warp]
    assert sorted(flat) == list(range(rows)) and len(set(flat)) == rows
    assert all(any(warp for warp in blk) for blk in split)
    assert all(len(blk) == (8 if k6.bwd_vec(d) else 1) for blk in split)
    taken = [(c, part) for blk in k6.dw_split(blocks, d)
             for c, run in blk for part in run]
    assert len(taken) == len(set(taken)) == d * blocks
    for blk in k6.dw_split(blocks, d):
        for _c, run in blk:
            assert run == sorted(run) == list(range(min(run, default=0),
                                                    max(run, default=-1) + 1))
    if (rows, d) == (4096, 896):
        assert blocks == 128 and k6.bwd_vec(d)


def _flash_state(qw, rows, ks, vs, tiles, bk, limit, c):
    """One warp's (m, l, acc) over key ``tiles`` (those below ``limit``),
    the kernel's arithmetic: S and P V in 3xTF32, the softmax in base 2."""
    wr, d = qw.shape
    m = np.full(wr, -np.inf, np.float32)
    l = np.zeros(wr, np.float32)
    acc = np.zeros((wr, d), np.float32)
    for t in tiles:
        k0 = t * bk
        if k0 >= limit:
            continue
        kt, vt = ks[k0:k0 + bk], vs[k0:k0 + bk]
        s = _3xtf32(qw, kt.T) * c
        keys = np.arange(k0, k0 + len(kt))
        s = np.where(keys[None, :] <= rows[:, None], s, -np.inf)
        m_new = np.maximum(m, s.max(axis=1))
        a = np.where(np.isinf(m_new), 1, np.exp2(m - m_new))
        pr = np.where(np.isinf(m_new)[:, None], 0,
                      np.exp2(s - m_new[:, None])).astype(np.float32)
        l = l * a + pr.sum(axis=1)
        acc = acc * a[:, None] + _3xtf32(pr, vt)
        m = m_new
    return m, l, acc


def _flash_kv_splits():
    """The planner's pick at 130 causal rows of Qwen2-0.5B's heads, and a
    plan there whose two warp groups split the key tiles."""
    call = (1, 14, 2, 130, 130, 64, True, 0, None)
    split = next(p for _k, p in aplan.flash_candidates(*call)
                 if p.kv_split == 2)
    return [aplan.plan_flash(*call[:6]), split]


@pytest.mark.parametrize("plan", _flash_kv_splits(),
                         ids=["picked", "kv_split"])
def test_flash_3xtf32_emulation_matches_reference(plan):
    """K7 flash at Qwen2-0.5B's heads (14 on 2 kv heads, D 64) over 130
    causal rows, as the kernel runs it under ``plan``: each warp's 16 rows
    walk the key tiles they see (with a key split, each of two groups its
    half of the q tile's tiles, the two states merged at the end), S = Q
    K^T and O += P V in 3xTF32 with the operands split as
    ``tc::split_tf32_bits`` splits them, the online softmax in base 2
    between them, O / l at the end; within 1e-4 of the reference's
    ``flash_attention`` in interpret mode."""
    b, hq, hkv, sq, d = 1, 14, 2, 130, 64
    q, k, v = _arrays(16, (b, hq, sq, d), (b, hkv, sq, d), (b, hkv, sq, d),
                      scale=0.5)
    p, wr = plan, aplan.WARP_ROWS
    c = np.float32(np.log2(np.e) / np.sqrt(d))
    got = np.zeros_like(q)
    for h in range(hq):
        qs, ks, vs = q[0, h], k[0, h // (hq // hkv)], v[0, h // (hq // hkv)]
        for qt in range(p.q_tiles):
            n = -(-min(sq, (qt + 1) * p.rows) // p.bk)
            half = -(-n // 2)
            groups = ([range(n)] if p.kv_split == 1
                      else [range(half), range(half, n)])
            for r0 in range(qt * p.rows, min(sq, (qt + 1) * p.rows), wr):
                rows, nr = np.arange(r0, r0 + wr), min(wr, sq - r0)
                qw = np.zeros((wr, d), np.float32)
                qw[:nr] = qs[r0:r0 + nr]
                (m, l, acc), *rest = [
                    _flash_state(qw, rows, ks, vs, tiles, p.bk,
                                 min(sq, r0 + wr), c) for tiles in groups]
                for mo, lo, ao in rest:
                    mn = np.maximum(m, mo)
                    fa = np.where(np.isinf(m), 0, np.exp2(m - mn))
                    fb = np.where(np.isinf(mo), 0, np.exp2(mo - mn))
                    l, acc = l * fa + lo * fb, (acc * fa[:, None]
                                                + ao * fb[:, None])
                got[0, h, r0:r0 + nr] = (acc / l[:, None])[:nr]
    ref = ref_flash_attention(_j(q), _j(k), _j(v), causal=True, block_q=32,
                              block_k=32, interpret=True)
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)


# --------------------------------------------------------------------------
# K1's arithmetic: 3xTF32 emulated on the CPU
# --------------------------------------------------------------------------
def _tf32(a):
    """cvt.rna.tf32.f32: round to the nearest tf32 (10 mantissa bits), ties
    away from zero, on the bit pattern."""
    u = a.astype(np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _k1_3xtf32(x, w, b, act, plan):
    """K1's products as the kernel runs them: operands split into tf32 hi
    and lo, each rank's hi*hi and lo*hi + hi*lo summed apart (lo*lo
    dropped) over its K range, added once; the ranks' partials then summed
    in rank order, the bias and the activation after."""
    xh, wh = _tf32(x), _tf32(w)
    xl, wl = _tf32(x - xh), _tf32(w - wh)
    out = np.zeros((x.shape[0], w.shape[1]), np.float32)
    for lo, hi in gplan.k_splits(x.shape[1], plan.bk, plan.cluster):
        s = slice(lo, hi)
        main = xh[:, s] @ wh[s]
        corr = xl[:, s] @ wh[s] + xh[:, s] @ wl[s]
        out = out + (main + corr)
    out = out + b
    return {"relu": np.maximum(out, 0), None: out}[act]


@pytest.mark.parametrize("m,k,n,act", [(2, 1280, 1000, None),
                                       (98, 1024, 1024, "relu")])
def test_k1_3xtf32_emulation_matches_reference(m, k, n, act):
    """At the paths' largest K (MobileNet v2's head, 2 x 1280 x 1000, and
    MobileNet v1's 98 x 1024 x 1024), K1's 3xTF32 arithmetic under its plan
    stays within 1e-4 of the reference Pallas kernel in interpret mode,
    and much closer to an f64 product than plain TF32 would."""
    x, w, b = _arrays(9, (m, k), (k, n), (n,))
    w = (w * np.sqrt(2.0 / k)).astype(np.float32)
    b = (b * 0.1).astype(np.float32)
    plan = gplan.plan_k1(m, k, n)
    got = _k1_3xtf32(x, w, b, act, plan)
    ref = ref_matmul(_j(x), _j(w), _j(b), act=act, interpret=True)
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)
    exact = x.astype(np.float64) @ w.astype(np.float64) + b
    exact = np.maximum(exact, 0) if act == "relu" else exact
    one_pass = _tf32(x) @ _tf32(w) + b
    one_pass = np.maximum(one_pass, 0) if act == "relu" else one_pass
    assert np.abs(got - exact).max() < np.abs(one_pass - exact).max() / 20


# --------------------------------------------------------------------------
# dispatch rules
# --------------------------------------------------------------------------
@pytest.mark.parametrize("model", ["mobilenet_v1", "mobilenet_v2",
                                   "squeezenet"])
def test_conv_dispatch_rule(model, monkeypatch):
    """A 1x1 conv with stride 1 and pad 0 (and the fc head) goes to K1,
    every other conv to K3: the reference's ``conv_gemm/ops.py`` rule."""
    calls = []
    monkeypatch.setattr(conv_ops, "matmul_bias_act",
                        lambda *a, **k: calls.append("K1") or a[0] @ a[1])
    monkeypatch.setattr(conv_ops, "conv2d_implicit_gemm",
                        lambda x, w, *a, **k: calls.append("K3"))
    for l in get_graph(model).layers:
        if l.op == "dwconv":
            continue
        x = torch.zeros((1, 3, 3, l.C_i))
        w = torch.zeros((l.K_h, l.K_w, l.C_i, l.C_o))
        conv_ops.conv2d_gemm(x, w, None, stride=l.stride, pad=l.pad)
        want = ("K1" if (l.K_h, l.K_w, l.stride, l.pad) == (1, 1, 1, 0)
                else "K3")
        assert calls.pop() == want, l.name
        if l.op == "fc":
            assert want == "K1"


def test_wrappers_refuse_other_devices():
    x = torch.zeros((4, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        matmul_bias_act(x, torch.zeros((4, 4), device="meta"))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        check_cuda_operands("k", torch.device("cpu"), x=torch.zeros(1))


def test_launch_refuses_tensors_past_32_bit_indexing(monkeypatch):
    import repro_torch.kernels.util as util
    monkeypatch.setattr(util, "kernel_library", _never_built)
    big = torch.empty(2 ** 31, device="meta")
    with pytest.raises(ValueError, match="32-bit"):
        util.launch("repro_matmul_bias_act", torch.device("cuda"), big)


def _never_built():
    raise AssertionError("the size check must come before the build")


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    import repro_torch.kernels.util as util
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(util, "Path", _NoNvccPath)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        find_nvcc()


class _NoNvccPath(type(__import__("pathlib").Path())):
    """A Path whose /usr/local/cuda/bin/nvcc never exists."""

    def is_file(self):
        return False


def _3xtf32(a, b):
    """a @ b as the kernels run it: hi*hi plus the two correction terms
    (lo*lo dropped), the main and correction products summed apart."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (ah @ bh) + (al @ bh + ah @ bl)


def test_k3_3xtf32_emulation_matches_reference():
    """K3 at SqueezeNet's 14^2, Ci 64 -> 256 layer (K = 576): the patch
    matrix times the weight in 3xTF32 over each cluster rank's k-steps
    under ``plan_k3``, the ranks' partials summed in rank order, then the
    bias and relu, within 1e-4 of the reference Pallas kernel in interpret
    mode."""
    x, w, b = _arrays(14, (2, 14, 14, 64), (3, 3, 64, 256), (256,))
    w = (w * np.sqrt(2.0 / 576)).astype(np.float32)
    b = (b * 0.1).astype(np.float32)
    p = gplan.plan_k3(2, 14, 14, 64, 256, 3, 3, 1, 1, True)
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    pm = np.stack([xp[:, i:i + 14, j:j + 14, :] for i in range(3)
                   for j in range(3)], axis=3).reshape(392, 576)
    wm = w.reshape(576, 256)
    got = np.zeros((392, 256), np.float32)
    for lo, hi in gplan.k_splits(576, p.bk, p.cluster):
        got = got + _3xtf32(pm[:, lo:hi], wm[lo:hi])
    got = np.maximum(got + b, 0).reshape(2, 14, 14, 256)
    ref = ref_implicit_gemm(_j(x), _j(w), _j(b), stride=1, pad=1,
                            act="relu", interpret=True)
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)


def test_decode_3xtf32_emulation_matches_reference():
    """K7 decode at Granite's group (48 query heads on 1 kv head, D 128),
    as its tensor-core path runs it under ``plan_decode``: each rank's
    32-key tiles in order, S = Q K^T and P V in 3xTF32, the online softmax
    between them, then the ranks' states merged in rank order; within 1e-4
    of the reference's ``decode_attention`` in interpret mode."""
    q, k, v = _arrays(15, (2, 48, 1, 128), (2, 1, 100, 128),
                      (2, 1, 100, 128), scale=0.5)
    p = aplan.plan_decode(2, 48, 1, 100, 128)
    assert p.tc
    scale = 1.0 / np.sqrt(128)
    got = np.zeros((2, 48, 1, 128), np.float32)
    for bi in range(2):
        qs, ks, vs = q[bi, :, 0], k[bi, 0], v[bi, 0]
        states = []
        for lo, hi in aplan.key_splits(100, p.cluster):
            m = np.full(48, -np.inf, np.float32)
            l = np.zeros(48, np.float32)
            acc = np.zeros((48, 128), np.float32)
            for t in range(lo, hi, aplan.TK):
                kt, vt = ks[t:min(t + aplan.TK, hi)], vs[t:min(t + aplan.TK,
                                                               hi)]
                s = _3xtf32(qs, kt.T) * np.float32(scale)
                m_new = np.maximum(m, s.max(axis=1))
                a = np.exp(m - m_new)
                pr = np.exp(s - m_new[:, None])
                l = l * a + pr.sum(axis=1)
                acc = acc * a[:, None] + _3xtf32(pr.astype(np.float32), vt)
                m = m_new
            states.append((m, l, acc))
        mx = np.max([st[0] for st in states], axis=0)
        fs = [np.where(np.isinf(st[0]), 0, np.exp(st[0] - mx))
              for st in states]
        lsum = sum(f * st[1] for f, st in zip(fs, states))
        got[bi, :, 0] = sum(st[2] * (f / lsum)[:, None]
                            for f, st in zip(fs, states))
    ref = ref_decode_attention(_j(q), _j(k), _j(v), interpret=True)
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)
