"""Row RMSNorm (K6), differentiable.

Wrapper of the hand-written CUDA kernels in ``csrc/rmsnorm.cu``.  The
forward replaces the TPU kernel ``repro/kernels/rmsnorm/kernel.py::
rmsnorm``; the source says what bounds it on an H100 (bytes, though at the
LM path's sizes its launch and memory latency set its time) and how a warp
per row keeps the row in registers between the reduction and the scale.
The backward (``rmsnorm_bwd``, entry ``repro_rmsnorm_bwd``) replaces no
TPU kernel: the reference trains through ``rmsnorm_ref`` and ``jax.grad``.
It is the port's own, because the forward runs K6 on every LM path and its
output, filled by a C call, has no gradient of its own.

Where autograd records (grad mode on and ``x`` or ``w`` requiring grad)
:func:`rmsnorm` goes through ``_RMSNorm``, a ``torch.autograd.Function``
whose backward is ``rmsnorm_bwd``; elsewhere (serving) it launches the
forward directly, as before.

The forward's launch is programmatic dependent where ``w`` is a weight
nothing writes: the kernel reads ``w`` before it waits for the kernel
ahead of it in the stream, so that kernel must not write ``w``; ``x`` is
read after the wait.  In training the optimizer writes every ``w``, so
where ``w`` requires grad the forward is launched the plain way (the
stream orders it after every earlier kernel); the backward is always
launched the plain way.  So no K6 launch is the dependent of a kernel that
writes its ``w``.

A CUDA tensor launches the kernel on the current stream (or raises); a CPU
tensor runs the plain version from ``ref.py``.  ``rmsnorm.launches`` and
``rmsnorm_bwd.launches`` count the launches (a backward call is one launch
of its entry: the row pass and the fixed-order sum of ``dw``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref, rmsnorm_ref
from repro_torch.kernels.util import (cdiv, check_cuda_operands, counted,
                                      launch)

#: the backward's row blocks: up to two a streaming multiprocessor of the
#: H100, each summing its rows' share of dw
BWD_MAX_BLOCKS = 264


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() < 1 or w.dim() != 1 or w.shape[0] != x.shape[-1]:
        raise ValueError(f"rmsnorm: x {tuple(x.shape)}, w {tuple(w.shape)}")


def _forward(x: torch.Tensor, w: torch.Tensor, eps: float,
             pdl: bool) -> torch.Tensor:
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, eps)
    check_cuda_operands("rmsnorm", x.device, x=x, w=w)
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    out = torch.empty_like(x)
    if rows == 0:
        return out
    launch("repro_rmsnorm", x.device, x, w, out, rows, d, float(eps),
           int(pdl))
    rmsnorm.launches += 1
    return out


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return _forward(x, w, eps, pdl=not ctx.needs_input_grad[1])

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(x, w, dy.contiguous(), eps=ctx.eps)
        return dx, dw, None


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (..., d); w: (d,)."""
    _check(x, w)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _RMSNorm.apply(x, w, eps)
    return _forward(x, w, eps, pdl=True)


def bwd_blocks(rows: int) -> int:
    """The backward's row blocks for ``rows`` rows (each takes
    ``cdiv(rows, blocks)`` rows; its partial dw is one row of scratch)."""
    return cdiv(rows, cdiv(rows, min(rows, BWD_MAX_BLOCKS)))


def rmsnorm_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, *,
                eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradients (dx, dw) of ``rmsnorm(x, w, eps=eps)`` given ``dy``,
    the output's: dx (..., d), dw (d,) summed over the rows.  dw sums each
    block's rows, then the blocks in order: no atomics, so the bits do not
    depend on scheduling."""
    _check(x, w)
    if dy.shape != x.shape:
        raise ValueError(f"rmsnorm_bwd: dy {tuple(dy.shape)}, x "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return rmsnorm_bwd_ref(x, w, dy, eps)
    check_cuda_operands("rmsnorm_bwd", x.device, x=x, w=w, dy=dy)
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    dx = torch.empty_like(x)
    if rows == 0:
        return dx, torch.zeros_like(w)
    dw = torch.empty_like(w)
    blocks = bwd_blocks(rows)
    part = torch.empty((blocks, d), dtype=torch.float32, device=x.device)
    launch("repro_rmsnorm_bwd", x.device, x, w, dy, dx, part, dw, rows, d,
           blocks, float(eps))
    rmsnorm_bwd.launches += 1
    return dx, dw


counted(rmsnorm)
counted(rmsnorm_bwd)
