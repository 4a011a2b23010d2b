"""MobileNet v2's layer table (arXiv:1801.04381, Table 2) from its
configuration file: a 3x3 stem, inverted residual blocks (1x1 expansion
unless t = 1, 3x3 depthwise, linear 1x1 projection, the identity added
where the stride is 1 and the channels are unchanged), a 1x1 conv to the
last channels, a global average pool and the classifier."""
from __future__ import annotations

from bench.reference.plain import Layer


def layers(cfg: dict) -> list[Layer]:
    """The layer table of ``cfg`` (``configs/mobilenet_v2.json``)."""
    h, c = cfg["image_px"], cfg["stem_channels"]
    out = [Layer("conv1", "conv", h, cfg["in_channels"], c, k=3, stride=2,
                 pad=1)]
    h = out[-1].h_out
    b = 0
    for t, c_out, n, s in cfg["blocks"]:
        for r in range(n):
            b += 1
            stride = s if r == 0 else 1
            mid = c * t
            residual = stride == 1 and c == c_out
            if t != 1:
                out.append(Layer(f"b{b}_expand", "conv", h, c, mid,
                                 stash=residual))
            dw = Layer(f"b{b}_dw", "dw", h, mid, mid, k=3, stride=stride,
                       pad=1, stash=residual and t == 1)
            out.append(dw)
            h = dw.h_out
            out.append(Layer(f"b{b}_project", "conv", h, mid, c_out,
                             act=None, add=residual))
            c = c_out
    out.append(Layer("conv_last", "conv", h, c, cfg["last_channels"]))
    out.append(Layer("fc", "fc", 1, cfg["last_channels"],
                     cfg["num_classes"], act=None))
    return out
