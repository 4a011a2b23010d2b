"""Dispatch wrapper: 2D convolution on the c-core kernels.

Counterpart of ``repro/kernels/conv_gemm/ops.py``, with its rule: a 1x1 conv
with stride 1 and pad 0 (every pointwise conv, and the fc head on its 1x1
map) flattens pixels and runs the GEMM (K1); any other conv runs the
implicit GEMM (K3).  As in the reference, each call builds its layer
signature and consults the plan cache (``kernels/autotune.py``) first: a
cached entry for the card and the SMs of the current stream gives the
tiling, a miss the planner's pick (``plan.py``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import autotune
from repro_torch.kernels.conv_gemm.kernel import (conv2d_implicit_gemm,
                                                  matmul_bias_act)


def conv2d_gemm(x: torch.Tensor, w: torch.Tensor,
                bias: torch.Tensor | None = None, *, stride: int = 1,
                pad: int = 0, act: str | None = None) -> torch.Tensor:
    """NHWC conv with fused bias/activation epilogue.

    x: (N, H, W, C_i); w: (K_h, K_w, C_i, C_o); bias: (C_o,) or None.
    """
    kh, kw, ci, co = w.shape
    if kh == 1 and kw == 1 and stride == 1 and pad == 0:
        return pointwise_conv(x, w.reshape(ci, co), bias, act=act)
    n, h, wd, _ = x.shape
    sig = autotune.LayerSig(
        kind="conv", H=h, W=wd, C_i=ci, C_o=co, K_h=kh, K_w=kw,
        stride=stride, pad=pad, dtype=autotune.dtype_name(x.dtype), N=n,
        vec=ci % 4 == 0 and x.data_ptr() % 16 == 0)
    return conv2d_implicit_gemm(x, w, bias, stride=stride, pad=pad, act=act,
                                plan=autotune.resolve(sig, x.device))


def pointwise_conv(x: torch.Tensor, w: torch.Tensor,
                   bias: torch.Tensor | None = None, *,
                   act: str | None = None) -> torch.Tensor:
    """1x1 conv fast path: one GEMM over the flattened pixels.  w: (C_i,
    C_o)."""
    n, h, wd, ci = x.shape
    co = w.shape[-1]
    sig = autotune.LayerSig(kind="pointwise", H=h, W=wd, C_i=ci, C_o=co,
                            dtype=autotune.dtype_name(x.dtype), N=n)
    out = matmul_bias_act(x.reshape(n * h * wd, ci), w, bias, act=act,
                          plan=autotune.resolve(sig, x.device))
    return out.reshape(n, h, wd, co)
