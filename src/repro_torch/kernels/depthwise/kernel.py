"""p-core analogue: the depthwise conv (K2).

Wrapper of the hand-written CUDA kernel ``csrc/depthwise_conv2d.cu``, which
replaces the TPU kernel ``repro/kernels/depthwise/kernel.py::
depthwise_conv2d``; the source says what bounds it on an H100 (bytes) and
how its shared-memory halo tiles stand in for the line buffer.  ``plan.py``
chooses each call's tiling (pixel tile, channel block, outputs a thread,
shared memory) from its shape, unless the caller passes a plan (the plan
cache's, ``kernels/autotune.py``); the wrapper passes it to the kernel,
which trusts it.

A CUDA tensor launches the kernel on the current stream (or raises); a CPU
tensor runs the plain version from ``ref.py``.  ``depthwise_conv2d.launches``
counts the launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.depthwise.plan import plan_k2
from repro_torch.kernels.depthwise.ref import depthwise_conv2d_ref
from repro_torch.kernels.util import (act_code, check_cuda_operands, counted,
                                     launch)


def depthwise_conv2d(x: torch.Tensor, w: torch.Tensor,
                     bias: torch.Tensor | None = None, *, stride: int = 1,
                     pad: int = 1, act: str | None = None,
                     plan=None) -> torch.Tensor:
    """NHWC depthwise conv.  x: (N,H,W,C); w: (K_h,K_w,C); bias: (C,).
    ``plan``: a DwPlan of this call (the plan cache's); ``plan_k2``'s pick
    when None."""
    if x.dim() != 4 or w.dim() != 3 or w.shape[2] != x.shape[3]:
        raise ValueError(f"depthwise_conv2d: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    n, h, wd, c = x.shape
    kh, kw, _ = w.shape
    if bias is not None and tuple(bias.shape) != (c,):
        raise ValueError(f"depthwise_conv2d: bias {tuple(bias.shape)}, "
                         f"expected ({c},)")
    ho = (h + 2 * pad - kh) // stride + 1
    wo = (wd + 2 * pad - kw) // stride + 1
    if ho < 1 or wo < 1:
        raise ValueError(f"depthwise_conv2d: empty output {ho}x{wo}")
    if x.device.type == "cpu":
        return depthwise_conv2d_ref(x, w, bias, stride=stride, pad=pad,
                                    act=act)
    check_cuda_operands("depthwise_conv2d", x.device, x=x, w=w, bias=bias)
    if plan is None:
        plan = plan_k2(n, h, wd, c, kh, kw, stride, pad)
    out = torch.empty((n, ho, wo, c), device=x.device, dtype=torch.float32)
    vec = int(c % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (
        x, w, out, *(() if bias is None else (bias,)))))
    launch("repro_depthwise_conv2d", x.device, x, w, bias, out, n, h, wd, c,
           kh, kw, stride, pad, ho, wo, act_code(act), plan.th, plan.tw,
           plan.cq, plan.ow, plan.smem_bytes, vec)
    depthwise_conv2d.launches += 1
    return out


counted(depthwise_conv2d)
