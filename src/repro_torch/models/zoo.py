"""Layer-graph definitions of the paper's workloads (§VI-A b).

MobileNet v1 [arXiv:1704.04861], MobileNet v2 [arXiv:1801.04381] and
SqueezeNet (interpreted as v1.1 — the Table IV cycle count of 447k on a
1152-multiplier core is only consistent with v1.1's ~360M MACs; v1.0's ~860M
would exceed 100% PE efficiency; recorded in DESIGN.md §7).

Copy of ``repro/models/zoo.py``: the port builds the same graphs, so its
schedules and exec plans equal the reference's (tests/test_torch_core.py).
"""
from __future__ import annotations

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


PAPER_WORKLOADS = {
    "mobilenet_v1": mobilenet_v1_graph,
    "mobilenet_v2": mobilenet_v2_graph,
    "squeezenet": squeezenet_graph,
}


def get_graph(name: str) -> LayerGraph:
    """The zoo graph called ``name``."""
    try:
        return PAPER_WORKLOADS[name]()
    except KeyError:
        raise KeyError(f"unknown workload {name!r}; "
                       f"choices: {sorted(PAPER_WORKLOADS)}") from None
