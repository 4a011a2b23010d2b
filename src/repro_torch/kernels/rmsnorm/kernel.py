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
stream orders it after every earlier kernel); the backward's rows pass
is launched the plain way, and its dw pass, the rows pass's dependent,
reads only the partials after ``griddepcontrol.wait``.  So no K6 launch
reads a ``w`` that the kernel it overlaps may write.

A CUDA tensor launches the kernel on the current stream (or raises); a CPU
tensor runs the plain version from ``ref.py``; a ``meta`` tensor (the dry
run) allocates what the CUDA branch allocates and counts the call's
operations in the open ``meta_ops`` counters, launching nothing.
``rmsnorm.launches`` and
``rmsnorm_bwd.launches`` count the launches (a backward call is one launch
of its entry: the rows pass, a warp a row where d % 4 == 0 and d <= 1024,
and the dw pass spread over the card, a programmatic dependent launch
that waits for the rows pass before it reads).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref, rmsnorm_ref
from repro_torch.kernels.util import (add_meta_ops, cdiv,
                                      check_cuda_operands, counted, launch)

#: the backward's rows pass where d % 4 == 0 and d <= VEC_MAX_D (the
#: warp-per-row kernel, 16-byte aligned operands): blocks of BWD_WARPS
#: warps, at most one an SM of the H100
BWD_SMS = 132
BWD_WARPS = 8
VEC_MAX_D = 1024
#: ... any other d (the general kernel, a row at a time a block): up to two
#: blocks an SM
BWD_MAX_BLOCKS = 264
#: the dw pass: a block takes DW_COLS columns, its DW_WARPS warps
#: contiguous runs of the partial rows
DW_COLS = 32
DW_WARPS = 8


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() < 1 or w.dim() != 1 or w.shape[0] != x.shape[-1]:
        raise ValueError(f"rmsnorm: x {tuple(x.shape)}, w {tuple(w.shape)}")


def _forward(x: torch.Tensor, w: torch.Tensor, eps: float,
             pdl: bool) -> torch.Tensor:
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, eps)
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    if x.device.type == "meta":
        add_meta_ops("rmsnorm", 4 * rows * d)
        return torch.empty_like(x)
    check_cuda_operands("rmsnorm", x.device, x=x, w=w)
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


def bwd_vec(d: int) -> bool:
    """Whether the backward's rows pass at width ``d`` is the warp-per-row
    kernel (given 16-byte aligned operands; the C entry checks those)."""
    return d % 4 == 0 and d <= VEC_MAX_D


def bwd_blocks(rows: int, d: int) -> int:
    """The backward's row blocks for ``rows`` rows of width ``d`` (each
    takes ``cdiv(rows, blocks)`` rows; its partial dw is one row of
    scratch): at most one an SM on the warp-per-row path, two on the
    general one."""
    cap = min(rows, BWD_SMS if bwd_vec(d) else BWD_MAX_BLOCKS)
    return cdiv(rows, cdiv(rows, cap))


def bwd_row_split(rows: int, d: int) -> list[list[list[int]]]:
    """Each row block's rows, by warp: the kernels' decoding (block x takes
    rows [x per, (x + 1) per); on the warp-per-row path warp w of 8 takes
    its rows w, w + 8, ...; the general path's block takes them all, one
    list)."""
    blocks = bwd_blocks(rows, d)
    per = cdiv(rows, blocks)
    out = []
    for x in range(blocks):
        mine = list(range(x * per, min(rows, (x + 1) * per)))
        out.append([mine[w::BWD_WARPS] for w in range(BWD_WARPS)]
                   if bwd_vec(d) else [mine])
    return out


def dw_split(blocks: int, d: int) -> list[list[tuple[int, list[int]]]]:
    """Each dw block's (column, partial rows) by warp: block x takes
    columns [32 x, 32 x + 32) below d, warp w of 8 the contiguous run
    [w blocks / 8, (w + 1) blocks / 8) of the partials (``tc::rank_range``),
    summed in order, then the warps' runs in warp order."""
    out = []
    for x in range(cdiv(d, DW_COLS)):
        cols = range(x * DW_COLS, min(d, (x + 1) * DW_COLS))
        out.append([(c, list(range(w * blocks // DW_WARPS,
                                   (w + 1) * blocks // DW_WARPS)))
                    for w in range(DW_WARPS) for c in cols])
    return out


def rmsnorm_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, *,
                eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradients (dx, dw) of ``rmsnorm(x, w, eps=eps)`` given ``dy``,
    the output's: dx (..., d), dw (d,) summed over the rows.  dw sums each
    warp's rows, then a block's warps, then the blocks in a fixed tree
    (``dw_split``): no atomics, so the bits do not depend on scheduling."""
    _check(x, w)
    if dy.shape != x.shape:
        raise ValueError(f"rmsnorm_bwd: dy {tuple(dy.shape)}, x "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return rmsnorm_bwd_ref(x, w, dy, eps)
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    if x.device.type != "meta":
        check_cuda_operands("rmsnorm_bwd", x.device, x=x, w=w, dy=dy)
    dx = torch.empty_like(x)
    if rows == 0:
        return dx, torch.zeros_like(w)
    dw = torch.empty_like(w)
    blocks = bwd_blocks(rows, d)
    part = torch.empty((blocks, d), dtype=torch.float32, device=x.device)
    if x.device.type == "meta":
        add_meta_ops("rmsnorm_bwd", 11 * rows * d)
        return dx, dw
    launch("repro_rmsnorm_bwd", x.device, x, w, dy, dx, part, dw, rows, d,
           blocks, float(eps))
    rmsnorm_bwd.launches += 1
    return dx, dw


counted(rmsnorm)
counted(rmsnorm_bwd)
