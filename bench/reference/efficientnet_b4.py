"""EfficientNet-B4's layer table (arXiv:1905.11946, Table 1 scaled by
width 1.4, depth 1.8, resolution 380) from its configuration file, and
its own forward: a 3x3 stem, MBConv blocks (a 1x1 expansion unless t = 1,
a k x k depthwise conv, a squeeze-and-excitation gate, a linear 1x1
projection, the identity added where the stride is 1 and the channels
are unchanged), a 1x1 conv to the last channels, a global average pool
and the classifier; silu after every conv but the projections and the
classifier.

The SE gate's two FCs are entries of their own class, :class:`GateFC`;
every other layer is a ``plain.Layer``.  :func:`se_work` counts the SE
gates' work, whatever kernels compute them."""
from __future__ import annotations

import dataclasses

import torch

from bench.reference.plain import (PRECISIONS, Layer, layer_forward, to_tf32,
                                   tf32_products)


@dataclasses.dataclass(frozen=True)
class GateFC:
    """An SE gate's reduce (``"silu"``) or expand (``"sigmoid"``) FC, on
    the pool of an ``h`` x ``h`` depthwise output."""

    name: str
    h: int
    c_in: int
    c_out: int
    act: str

    def weight_shape(self) -> tuple[int, ...]:
        """The served layout: HWIO of a 1x1 conv."""
        return (1, 1, self.c_in, self.c_out)

    @property
    def fan_in(self) -> int:
        return self.c_in

    @property
    def flops(self) -> int:
        """Multiply-adds of one image, times 2."""
        return 2 * self.c_in * self.c_out


def layers(cfg: dict) -> list:
    """The layer table of ``cfg`` (``configs/efficientnet_b4.json``)."""
    h, c = cfg["image_px"], cfg["stem_channels"]
    out: list = [Layer("stem", "conv", h, cfg["in_channels"], c, k=3,
                       stride=2, pad=1, act="silu")]
    h = out[-1].h_out
    b = 0
    for t, k, s, c_out, n in cfg["stages"]:
        for r in range(n):
            b += 1
            stride = s if r == 0 else 1
            mid = c * t
            residual = stride == 1 and c == c_out
            if t != 1:
                out.append(Layer(f"b{b}_expand", "conv", h, c, mid,
                                 act="silu", stash=residual))
            dw = Layer(f"b{b}_dw", "dw", h, mid, mid, k=k, stride=stride,
                       pad=k // 2, act="silu", stash=residual and t == 1)
            out.append(dw)
            h = dw.h_out
            se = max(1, int(c * cfg["se_ratio"]))
            out.append(GateFC(f"b{b}_se_reduce", h, mid, se, "silu"))
            out.append(GateFC(f"b{b}_se_expand", h, se, mid, "sigmoid"))
            out.append(Layer(f"b{b}_project", "conv", h, mid, c_out,
                             act=None, add=residual))
            c = c_out
    out.append(Layer("conv_last", "conv", h, c, cfg["last_channels"],
                     act="silu"))
    out.append(Layer("fc", "fc", 1, cfg["last_channels"],
                     cfg["num_classes"], act=None))
    return out


def _act(x: torch.Tensor, act: str | None) -> torch.Tensor:
    if act is None:
        return x
    if act == "silu":
        return torch.nn.functional.silu(x)
    if act == "sigmoid":
        return torch.sigmoid(x)
    raise ValueError(f"unknown activation {act!r}")


def forward(table: list, params: dict, x: torch.Tensor,
            precision: str = "f32") -> torch.Tensor:
    """Logits ``(N, classes)`` of NHWC images ``x`` through ``table``
    (``plain.forward``'s contract).  Every conv's and FC's operands are
    rounded to TF32 under ``"tf32"``; the pools, the gate's multiply and
    the residual adds stay float32."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    with tf32_products(precision == "tf32_library"):
        h = x.permute(0, 3, 1, 2).float()
        res = gate = None
        for l in table:
            p = params[l.name]
            if isinstance(l, GateFC):
                g = h.mean(dim=(2, 3)) if gate is None else gate
                w = p["w"].reshape(l.c_in, l.c_out)
                if precision == "tf32":
                    g, w = to_tf32(g), to_tf32(w)
                gate = _act(g @ w + p["b"], l.act)
                if l.act == "sigmoid":
                    h = h * gate[:, :, None, None]
                    gate = None
                continue
            if l.stash:
                res = h
            if l.op == "fc":
                h = h.mean(dim=(2, 3))
            h = _act(layer_forward(dataclasses.replace(l, act=None), h,
                                   p["w"], p["b"], precision), l.act)
            if l.add:
                h = h + res
        return h


def se_work(table: list, batch: int) -> tuple[int, int]:
    """The SE gates' FLOPs and byte floor for one request of ``batch``
    images: the pools' adds, the FCs' multiply-adds times 2 and the
    gate's multiplies; each depthwise output read once, and the FCs'
    weights and biases once."""
    flops = nbytes = 0
    for l in table:
        if not isinstance(l, GateFC):
            continue
        flops += batch * l.flops
        nbytes += 4 * (l.c_in * l.c_out + l.c_out)
        if l.act == "silu":                   # the reduce: its pool
            elems = l.h * l.h * l.c_in
            flops += batch * 2 * elems        # the pool's adds, the gate's
            nbytes += 4 * batch * elems       # multiplies; the map once
    return flops, nbytes
