"""Plain PyTorch version of the depthwise kernel (K2).

Counterpart of ``repro/kernels/depthwise/ref.py``.  It repeats the kernel's
arithmetic: taps accumulate in (i, j) order over strided slices of the
padded map, then bias and activation.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.util import apply_act


def depthwise_conv2d_ref(x: torch.Tensor, w: torch.Tensor,
                         bias: torch.Tensor | None = None, stride: int = 1,
                         pad: int = 1,
                         act: str | None = None) -> torch.Tensor:
    """NHWC depthwise conv.  x: (N,H,W,C); w: (K_h,K_w,C); bias: (C,)."""
    n, h, wd, c = x.shape
    kh, kw, cw = w.shape
    if cw != c:
        raise ValueError(f"depthwise: weight has {cw} channels, x has {c}")
    xp = F.pad(x.float(), (0, 0, pad, pad, pad, pad))
    ho = (h + 2 * pad - kh) // stride + 1
    wo = (wd + 2 * pad - kw) // stride + 1
    acc = torch.zeros((n, ho, wo, c), dtype=torch.float32, device=x.device)
    for i in range(kh):
        for j in range(kw):
            tap = xp[:, i:i + (ho - 1) * stride + 1:stride,
                     j:j + (wo - 1) * stride + 1:stride, :]
            acc = acc + tap * w[i, j].float()
    if bias is not None:
        acc = acc + bias.float()
    return apply_act(acc, act)
