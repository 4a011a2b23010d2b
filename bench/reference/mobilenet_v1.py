"""MobileNet v1's layer table (arXiv:1704.04861, Table 1) from its
configuration file: a 3x3 stem, then depthwise-separable blocks (3x3
depthwise, 1x1 conv), a global average pool and the classifier."""
from __future__ import annotations

from bench.reference.plain import Layer


def layers(cfg: dict) -> list[Layer]:
    """The layer table of ``cfg`` (``configs/mobilenet_v1.json``)."""
    h, c = cfg["image_px"], cfg["stem_channels"]
    out = [Layer("conv1", "conv", h, cfg["in_channels"], c, k=3, stride=2,
                 pad=1)]
    h = out[-1].h_out
    for i, (stride, c_out) in enumerate(cfg["blocks"], start=1):
        dw = Layer(f"dw{i}", "dw", h, c, c, k=3, stride=stride, pad=1)
        out.append(dw)
        h = dw.h_out
        out.append(Layer(f"pw{i}", "conv", h, c, c_out))
        c = c_out
    out.append(Layer("fc", "fc", 1, c, cfg["num_classes"], act=None))
    return out
