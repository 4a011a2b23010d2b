"""Layer-graph definitions of the served CNNs.

The paper's workloads (§VI-A b): MobileNet v1 [arXiv:1704.04861], MobileNet
v2 [arXiv:1801.04381] and SqueezeNet (interpreted as v1.1 — the Table IV
cycle count of 447k on a 1152-multiplier core is only consistent with
v1.1's ~360M MACs; v1.0's ~860M would exceed 100% PE efficiency; recorded in
DESIGN.md §7).  For those three this is a copy of ``repro/models/zoo.py``:
the port builds the same graphs, so its schedules and exec plans equal the
reference's (tests/test_torch_core.py).

Beyond the paper, the port alone serves EfficientNet [arXiv:1905.11946]:
:func:`efficientnet_graph` scales the B0 baseline by width, depth and
resolution, and ``efficientnet_b4`` is (1.4, 1.8, 380).  Its blocks add a
squeeze-and-excitation (SE) gate, two ``fc`` layers on the pooled
depthwise output, so that output has two consumers (the gate and the
projection) and no fusion crosses it (``core/fusion.py``).
"""
from __future__ import annotations

import math

from repro_torch.core.graph import LayerGraph, LayerSpec, chain_graph


# --------------------------------------------------------------------------
# MobileNet v1 (224x224x3, width multiplier 1.0)
# --------------------------------------------------------------------------
def mobilenet_v1_graph() -> LayerGraph:
    """MobileNet v1 at 224 px as a layer graph."""
    layers = [LayerSpec("conv1", "conv", 224, 224, 3, 32, 3, 3, 2, pad=1)]
    # (stride, C_out) per depthwise-separable block
    cfg = [(1, 64), (2, 128), (1, 128), (2, 256), (1, 256), (2, 512),
           (1, 512), (1, 512), (1, 512), (1, 512), (1, 512),
           (2, 1024), (1, 1024)]
    h, w, c = 112, 112, 32
    for i, (s, c_out) in enumerate(cfg, start=1):
        layers.append(LayerSpec(f"dw{i}", "dwconv", h, w, c, c, 3, 3, s,
                                pad=1))
        h, w = -(-h // s), -(-w // s)
        layers.append(LayerSpec(f"pw{i}", "conv", h, w, c, c_out, 1, 1, 1))
        c = c_out
    layers.append(LayerSpec("fc", "fc", 1, 1, 1024, 1000, 1, 1, 1,
                            fused=("avgpool",)))
    return chain_graph("mobilenet_v1", layers)


# --------------------------------------------------------------------------
# MobileNet v2 (224x224x3, width multiplier 1.0)
# --------------------------------------------------------------------------
MBV2_BLOCKS = [
    # (expansion t, C_out, repeats n, stride s) — Table 2 of the v2 paper
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
]


def mobilenet_v2_graph() -> LayerGraph:
    """MobileNet v2 at 224 px as a layer graph."""
    layers = [LayerSpec("conv1", "conv", 224, 224, 3, 32, 3, 3, 2, pad=1)]
    h, w, c = 112, 112, 32
    bi = 0
    for t, c_out, n, s in MBV2_BLOCKS:
        for r in range(n):
            stride = s if r == 0 else 1
            bi += 1
            c_mid = c * t
            if t != 1:
                layers.append(LayerSpec(f"b{bi}_expand", "conv",
                                        h, w, c, c_mid, 1, 1, 1))
            layers.append(LayerSpec(f"b{bi}_dw", "dwconv",
                                    h, w, c_mid, c_mid, 3, 3, stride, pad=1))
            h, w = -(-h // stride), -(-w // stride)
            fused = ("add",) if (stride == 1 and c == c_out and r > 0) else ()
            layers.append(LayerSpec(f"b{bi}_project", "conv",
                                    h, w, c_mid, c_out, 1, 1, 1, fused=fused))
            c = c_out
    layers.append(LayerSpec("conv_last", "conv", h, w, c, 1280, 1, 1, 1))
    layers.append(LayerSpec("fc", "fc", 1, 1, 1280, 1000, 1, 1, 1,
                            fused=("avgpool",)))
    return chain_graph("mobilenet_v2", layers)


# --------------------------------------------------------------------------
# SqueezeNet v1.1 (224x224x3)
# --------------------------------------------------------------------------
SQZ_FIRE = [
    # (name, H, W, C_in, squeeze, expand) after the preceding pool
    ("fire2", 56, 56, 64, 16, 64),
    ("fire3", 56, 56, 128, 16, 64),
    ("fire4", 28, 28, 128, 32, 128),
    ("fire5", 28, 28, 256, 32, 128),
    ("fire6", 14, 14, 256, 48, 192),
    ("fire7", 14, 14, 384, 48, 192),
    ("fire8", 14, 14, 384, 64, 256),
    ("fire9", 14, 14, 512, 64, 256),
]


def squeezenet_graph() -> LayerGraph:
    """SqueezeNet v1.1 at 224 px as a layer graph."""
    layers = [LayerSpec("conv1", "conv", 224, 224, 3, 64, 3, 3, 2, pad=1,
                        fused=("maxpool",))]
    edges: list[tuple[str, str]] = []
    prev = "conv1"
    for name, h, w, c_in, sq, ex in SQZ_FIRE:
        squeeze = LayerSpec(f"{name}_squeeze", "conv", h, w, c_in, sq, 1, 1, 1)
        e1 = LayerSpec(f"{name}_e1x1", "conv", h, w, sq, ex, 1, 1, 1)
        e3 = LayerSpec(f"{name}_e3x3", "conv", h, w, sq, ex, 3, 3, 1, pad=1,
                       fused=("concat",))
        layers += [squeeze, e1, e3]
        edges += [(prev, squeeze.name), (squeeze.name, e1.name),
                  (squeeze.name, e3.name)]
        prev = e3.name  # concat(e1, e3) feeds the next fire/conv
        edges.append((e1.name, e3.name))  # concat dependency marker
    layers.append(LayerSpec("conv10", "conv", 14, 14, 512, 1000, 1, 1, 1,
                            fused=("avgpool",)))
    edges.append((prev, "conv10"))
    return LayerGraph("squeezenet", layers, edges)


# --------------------------------------------------------------------------
# EfficientNet (B0 scaled by width, depth and resolution)
# --------------------------------------------------------------------------
EFFNET_B0_STAGES = [
    # (expansion t, kernel k, stride s, C_out, repeats n) — Table 1 of the
    # EfficientNet paper (B0)
    (1, 3, 1, 16, 1),
    (6, 3, 2, 24, 2),
    (6, 5, 2, 40, 2),
    (6, 3, 2, 80, 3),
    (6, 5, 1, 112, 3),
    (6, 5, 2, 192, 4),
    (6, 3, 1, 320, 1),
]
EFFNET_B0_STEM = 32
EFFNET_B0_HEAD = 1280
#: an SE gate's channels over its block's input channels
EFFNET_SE_RATIO = 0.25


def round_channels(c: float, divisor: int = 8) -> int:
    """Channels scaled by a width coefficient, rounded to a multiple of
    ``divisor`` and never more than 10% below (the authors' rule, as
    torchvision's ``_make_divisible`` has it)."""
    out = max(divisor, int(c + divisor / 2) // divisor * divisor)
    return out + divisor if out < 0.9 * c else out


def efficientnet_stages(width: float, depth: float
                        ) -> list[tuple[int, int, int, int, int]]:
    """The B0 stages scaled: channels by ``width`` (rounded to 8), repeats
    by ``depth`` (rounded up)."""
    return [(t, k, s, round_channels(c * width), math.ceil(n * depth))
            for t, k, s, c, n in EFFNET_B0_STAGES]


def efficientnet_graph(width: float, depth: float, image_px: int,
                       name: str = "efficientnet") -> LayerGraph:
    """EfficientNet at ``image_px``: B0 scaled by ``width`` and ``depth``.

    A 3x3 stride-2 stem, then MBConv blocks ``b{i}``: a 1x1 expansion
    (unless t = 1), a k x k depthwise conv, the SE gate (``_se_reduce``
    then ``_se_expand``: ``fc`` layers on the pooled depthwise output,
    ``max(1, block input // 4)`` channels wide, the gate scaling that
    output per channel) and a linear 1x1 projection that adds the block's
    input where the stride is 1 and the channels are unchanged; a 1x1
    head conv, a global average pool and the classifier.  Every conv pads
    ``k // 2`` on each side.  The SE layers' edges run dw -> reduce ->
    expand -> project, beside dw -> project.
    """
    stem = round_channels(EFFNET_B0_STEM * width)
    layers = [LayerSpec("stem", "conv", image_px, image_px, 3, stem, 3, 3,
                        2, pad=1)]
    edges: list[tuple[str, str]] = []
    h, c = layers[0].H_out, stem
    prev = "stem"
    bi = 0
    for t, k, s, c_out, n in efficientnet_stages(width, depth):
        for r in range(n):
            bi += 1
            stride = s if r == 0 else 1
            mid = c * t
            se = max(1, int(c * EFFNET_SE_RATIO))
            block: list[LayerSpec] = []
            if t != 1:
                block.append(LayerSpec(f"b{bi}_expand", "conv", h, h, c, mid,
                                       1, 1, 1))
            dw = LayerSpec(f"b{bi}_dw", "dwconv", h, h, mid, mid, k, k,
                           stride, pad=k // 2)
            block.append(dw)
            h = dw.H_out
            reduce = LayerSpec(f"b{bi}_se_reduce", "fc", 1, 1, mid, se, 1, 1,
                               1, fused=("avgpool",))
            expand = LayerSpec(f"b{bi}_se_expand", "fc", 1, 1, se, mid, 1,
                               1, 1)
            fused = ("add",) if stride == 1 and c == c_out else ()
            project = LayerSpec(f"b{bi}_project", "conv", h, h, mid, c_out,
                                1, 1, 1, fused=fused)
            block += [reduce, expand, project]
            layers += block
            chain = [prev] + [l.name for l in block if l is not reduce
                              and l is not expand]
            edges += list(zip(chain, chain[1:]))
            edges += [(dw.name, reduce.name), (reduce.name, expand.name),
                      (expand.name, project.name)]
            prev, c = project.name, c_out
    head = round_channels(EFFNET_B0_HEAD * width)
    layers.append(LayerSpec("conv_last", "conv", h, h, c, head, 1, 1, 1))
    layers.append(LayerSpec("fc", "fc", 1, 1, head, 1000, 1, 1, 1,
                            fused=("avgpool",)))
    edges += [(prev, "conv_last"), ("conv_last", "fc")]
    return LayerGraph(name, layers, edges)


def efficientnet_b4_graph() -> LayerGraph:
    """EfficientNet-B4 at 380 px: width 1.4, depth 1.8."""
    return efficientnet_graph(1.4, 1.8, 380, "efficientnet_b4")


PAPER_WORKLOADS = {
    "mobilenet_v1": mobilenet_v1_graph,
    "mobilenet_v2": mobilenet_v2_graph,
    "squeezenet": squeezenet_graph,
}

#: every graph :func:`get_graph` resolves: the paper's and the port's own
ZOO = {**PAPER_WORKLOADS, "efficientnet_b4": efficientnet_b4_graph}


def get_graph(name: str) -> LayerGraph:
    """The zoo graph called ``name``."""
    try:
        return ZOO[name]()
    except KeyError:
        raise KeyError(f"unknown workload {name!r}; "
                       f"choices: {sorted(ZOO)}") from None
