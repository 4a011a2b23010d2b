"""Dispatch wrapper for the depthwise kernel.

Counterpart of ``repro/kernels/depthwise/ops.py``.  The reference picks a
channel block so that a whole padded image fits a VMEM budget, unless its
autotune cache holds one; here, as there, each call builds its layer
signature and consults the plan cache (``kernels/autotune.py``) first, and
a miss takes the planner's tiling of space and channels (``plan.py``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import autotune
from repro_torch.kernels.depthwise.kernel import depthwise_conv2d


def depthwise(x: torch.Tensor, w: torch.Tensor,
              bias: torch.Tensor | None = None, *, stride: int = 1,
              pad: int = 1, act: str | None = None) -> torch.Tensor:
    """NHWC depthwise conv with fused bias/activation."""
    n, h, wd, c = x.shape
    kh, kw, _ = w.shape
    sig = autotune.LayerSig(kind="depthwise", H=h, W=wd, C_i=c, C_o=c,
                            K_h=kh, K_w=kw, stride=stride, pad=pad,
                            dtype=autotune.dtype_name(x.dtype), N=n)
    return depthwise_conv2d(x, w, bias, stride=stride, pad=pad, act=act,
                            plan=autotune.resolve(sig, x.device))
