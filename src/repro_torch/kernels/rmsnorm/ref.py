"""Plain PyTorch version of the RMSNorm kernel (K6).

Counterpart of ``repro/kernels/rmsnorm/ref.py``: the mean of squares in
f32, then rsqrt, then the scale, in the kernel's order; and
``rmsnorm_bwd_ref``, the plain version of the port's backward kernel
(the reference differentiates ``rmsnorm_ref`` with ``jax.grad`` and has
no backward kernel).
"""
from __future__ import annotations

import torch


def _wide(t: torch.Tensor) -> torch.Tensor:
    """t in f32, or f64 as it is (the tests' exact gradients)."""
    return t if t.dtype == torch.float64 else t.float()


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """x: (..., d); w: (d,).  In f32 (f64 for f64 inputs)."""
    xf, wf = _wide(x), _wide(w)
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * wf).to(x.dtype)


def rmsnorm_bwd_ref(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                    eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradients of ``rmsnorm_ref(x, w, eps)`` given ``dy``, the
    output's: (dx (..., d), dw (d,) summed over the rows).  With r =
    rsqrt(mean(x^2) + eps) and g = dy * w: dx = r g - x r^3 mean(g x)."""
    d = x.shape[-1]
    xf, dyf = _wide(x), _wide(dy)
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    g = dyf * _wide(w)
    dot = torch.sum(g * xf, dim=-1, keepdim=True) / d
    dx = r * g - xf * (r * r * r) * dot
    dw = torch.sum((dyf * xf * r).reshape(-1, d), dim=0)
    return dx.to(x.dtype), dw.to(w.dtype)
