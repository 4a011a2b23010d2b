"""Plain PyTorch version of the RMSNorm kernel (K6).

Counterpart of ``repro/kernels/rmsnorm/ref.py``: the mean of squares in
f32, then rsqrt, then the scale, in the kernel's order.
"""
from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """x: (..., d); w: (d,)."""
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * w.float()).to(x.dtype)
