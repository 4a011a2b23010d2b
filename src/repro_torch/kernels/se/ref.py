"""Plain PyTorch versions of the SE gate's two kernels.

The gate of an NHWC map ``x`` (N, H, W, C) is
``sigmoid(silu(mean_hw(x) @ w1 + b1) @ w2 + b2)``, (N, C); the scale
multiplies the map by it per image and channel.  The wrappers in
``kernel.py`` take these for CPU tensors, and the card tests hold the CUDA
kernels against them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.util import apply_act


def se_gate_ref(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor | None,
                w2: torch.Tensor, b2: torch.Tensor | None) -> torch.Tensor:
    """The gate (N, C) of ``x``: w1 (C, S), b1 (S,), w2 (S, C), b2 (C,)."""
    r = x.float().mean(dim=(1, 2)) @ w1.float()
    if b1 is not None:
        r = r + b1.float()
    g = apply_act(r, "silu") @ w2.float()
    if b2 is not None:
        g = g + b2.float()
    return apply_act(g, "sigmoid")


def se_scale_ref(x: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """``x`` (N, H, W, C) times ``gate`` (N, C), as a new tensor."""
    return x * gate[:, None, None, :]
