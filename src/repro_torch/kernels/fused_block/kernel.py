"""Fused depthwise -> pointwise block (K4), the dw map kept on chip.

Wrapper of the hand-written CUDA kernel ``csrc/fused_dw_pw_conv.cu``, which
replaces the TPU kernel ``repro/kernels/fused_block/kernel.py::
fused_dw_pw_conv``; the source says what bounds it on an H100 and how it
tiles space and channels so that the dw values live only in shared memory.

The reference's second fused kernel, ``fused_pw_dw_pw_conv`` (K5, the
inverted residual), is not ported yet: see ``ops.fused_inverted_residual``.

A CUDA tensor launches the kernel on the current stream (or raises); a CPU
tensor runs the plain version from ``ref.py``.  ``fused_dw_pw_conv.launches``
counts the launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_block.ref import fused_dw_pw_ref
from repro_torch.kernels.util import act_code, check_cuda_operands, launch


def fused_dw_pw_conv(x: torch.Tensor, dw_w: torch.Tensor,
                     dw_b: torch.Tensor | None, pw_w: torch.Tensor,
                     pw_b: torch.Tensor | None,
                     residual: torch.Tensor | None = None, *,
                     stride: int = 1, pad: int = 1,
                     dw_act: str | None = "relu6",
                     pw_act: str | None = None) -> torch.Tensor:
    """dw(KhxKw, stride) -> pw(1x1) in one launch.

    x: (N,H,W,C); dw_w: (Kh,Kw,C); pw_w: (C,Co); biases (C,)/(Co,) or None;
    residual: (N,Ho,Wo,Co) or None (added after pw_act).
    """
    if (x.dim() != 4 or dw_w.dim() != 3 or pw_w.dim() != 2
            or dw_w.shape[2] != x.shape[3] or pw_w.shape[0] != x.shape[3]):
        raise ValueError(f"fused_dw_pw_conv: x {tuple(x.shape)}, dw_w "
                         f"{tuple(dw_w.shape)}, pw_w {tuple(pw_w.shape)}")
    n, h, wd, c = x.shape
    kh, kw, _ = dw_w.shape
    co = pw_w.shape[1]
    ho = (h + 2 * pad - kh) // stride + 1
    wo = (wd + 2 * pad - kw) // stride + 1
    if ho < 1 or wo < 1:
        raise ValueError(f"fused_dw_pw_conv: empty output {ho}x{wo}")
    for key, t, shape in (("dw_b", dw_b, (c,)), ("pw_b", pw_b, (co,)),
                          ("residual", residual, (n, ho, wo, co))):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"fused_dw_pw_conv: {key} {tuple(t.shape)}, "
                             f"expected {shape}")
    if x.device.type == "cpu":
        return fused_dw_pw_ref(x, dw_w, dw_b, pw_w, pw_b, residual,
                               stride=stride, pad=pad, dw_act=dw_act,
                               pw_act=pw_act)
    check_cuda_operands("fused_dw_pw_conv", x.device, x=x, dw_w=dw_w,
                        dw_b=dw_b, pw_w=pw_w, pw_b=pw_b, residual=residual)
    out = torch.empty((n, ho, wo, co), device=x.device, dtype=torch.float32)
    launch("repro_fused_dw_pw_conv", x.device, x, dw_w, dw_b, pw_w, pw_b,
           residual, out, n, h, wd, c, co, kh, kw, stride, pad, ho, wo,
           act_code(dw_act), act_code(pw_act))
    fused_dw_pw_conv.launches += 1
    return out


fused_dw_pw_conv.launches = 0
