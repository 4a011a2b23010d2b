"""Dispatch wrapper for the depthwise kernel.

Counterpart of ``repro/kernels/depthwise/ops.py``.  The reference picks a
channel block so that a whole padded image fits a VMEM budget; the CUDA
kernel's wrapper takes its tiling of space and channels from ``plan.py``,
so there is nothing to pick here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.depthwise.kernel import depthwise_conv2d


def depthwise(x: torch.Tensor, w: torch.Tensor,
              bias: torch.Tensor | None = None, *, stride: int = 1,
              pad: int = 1, act: str | None = None) -> torch.Tensor:
    """NHWC depthwise conv with fused bias/activation."""
    return depthwise_conv2d(x, w, bias, stride=stride, pad=pad, act=act)
