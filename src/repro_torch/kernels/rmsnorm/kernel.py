"""Row RMSNorm (K6).

Wrapper of the hand-written CUDA kernel ``csrc/rmsnorm.cu``, which replaces
the TPU kernel ``repro/kernels/rmsnorm/kernel.py::rmsnorm``; the source says
what bounds it on an H100 (bytes, though at the LM path's sizes its launch
and memory latency set its time) and how a warp per row keeps the row in
registers between the reduction and the scale.  The launch is
programmatic dependent: the kernel reads ``w`` before it waits for the
kernel ahead of it in the stream, so ``w`` must not be written by that
kernel (on the LM path it is a weight); ``x`` is read after the wait.

A CUDA tensor launches the kernel on the current stream (or raises); a CPU
tensor runs the plain version from ``ref.py``.  ``rmsnorm.launches`` counts
the launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.kernels.util import check_cuda_operands, counted, launch


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (..., d); w: (d,)."""
    if x.dim() < 1 or w.dim() != 1 or w.shape[0] != x.shape[-1]:
        raise ValueError(f"rmsnorm: x {tuple(x.shape)}, w {tuple(w.shape)}")
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, eps)
    check_cuda_operands("rmsnorm", x.device, x=x, w=w)
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    out = torch.empty_like(x)
    if rows == 0:
        return out
    launch("repro_rmsnorm", x.device, x, w, out, rows, d, float(eps))
    rmsnorm.launches += 1
    return out


counted(rmsnorm)
