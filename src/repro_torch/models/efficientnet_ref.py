"""EfficientNet's whole forward in plain PyTorch: the reference the port's
EfficientNet path is held against.

Float32 with TF32 off, NCHW inside and NHWC in, one ``F.conv2d`` or
matmul a layer; no kernel, no cache, no batching, and nothing of the
port's kernels (the stage table comes from ``models/zoo.py``, which the
tests hold against the published one).  Weights are in the port's layouts
(HWIO for a conv and an FC, ``(Kh, Kw, C)`` for a depthwise conv), one
``{"w", "b"}`` a layer of ``zoo.efficientnet_graph``.

Departures from the paper (arXiv:1905.11946), as the port serves it:
batch norm is folded into each conv's bias; every conv pads ``k // 2`` on
each side (TensorFlow's "SAME" pads stride-2 convs asymmetrically); an SE
gate is ``max(1, block input channels // 4)`` wide, as torchvision has it;
there is no dropout and no drop-connect, as at inference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.zoo import (EFFNET_B0_HEAD, EFFNET_B0_STEM,
                                    EFFNET_SE_RATIO, efficientnet_stages,
                                    round_channels)


def _conv(h: torch.Tensor, p: dict, stride: int = 1,
          pad: int = 0) -> torch.Tensor:
    return F.conv2d(h, p["w"].permute(3, 2, 0, 1), p["b"], stride=stride,
                    padding=pad)


def efficientnet_forward_ref(params: dict, x: torch.Tensor,
                             width: float = 1.4,
                             depth: float = 1.8) -> torch.Tensor:
    """Logits (N, 1000) of the NHWC images ``x`` through EfficientNet at
    ``width`` and ``depth`` (B4's by default) with ``params``."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        h = F.silu(_conv(x.permute(0, 3, 1, 2).float(), params["stem"],
                         stride=2, pad=1))
        c = round_channels(EFFNET_B0_STEM * width)
        b = 0
        for t, k, s, c_out, n in efficientnet_stages(width, depth):
            for r in range(n):
                b += 1
                stride = s if r == 0 else 1
                inp = h
                if t != 1:
                    h = F.silu(_conv(h, params[f"b{b}_expand"]))
                dw = params[f"b{b}_dw"]
                h = F.silu(F.conv2d(h, dw["w"].permute(2, 0, 1).unsqueeze(1),
                                    dw["b"], stride=stride, padding=k // 2,
                                    groups=h.shape[1]))
                se = max(1, int(c * EFFNET_SE_RATIO))
                pr, pe = params[f"b{b}_se_reduce"], params[f"b{b}_se_expand"]
                g = F.silu(h.mean(dim=(2, 3)) @ pr["w"].reshape(-1, se)
                           + pr["b"])
                g = torch.sigmoid(g @ pe["w"].reshape(se, -1) + pe["b"])
                h = _conv(h * g[:, :, None, None], params[f"b{b}_project"])
                if stride == 1 and c == c_out:
                    h = h + inp
                c = c_out
        h = F.silu(_conv(h, params["conv_last"]))
        fc = params["fc"]
        head = round_channels(EFFNET_B0_HEAD * width)
        return h.mean(dim=(2, 3)) @ fc["w"].reshape(head, -1) + fc["b"]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
