"""Dispatch wrappers for the fused MobileNet-block kernels (K4, K5).

Counterpart of ``repro/kernels/fused_block/ops.py``.  As in the reference,
each call builds its layer signature and consults the plan cache
(``kernels/autotune.py``) first: a cached entry for the card and the SMs of
the current stream gives the tiling, a miss the planner's pick
(``plan.py``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import autotune
from repro_torch.kernels.fused_block.kernel import (fused_dw_pw_conv,
                                                    fused_pw_dw_pw_conv)


def fused_dw_pw(x: torch.Tensor, dw_w: torch.Tensor, dw_b,
                pw_w: torch.Tensor, pw_b, residual=None, *, stride: int = 1,
                pad: int = 1, dw_act: str | None = "relu6",
                pw_act: str | None = None) -> torch.Tensor:
    """dw(KhxKw) -> pw(1x1) fused block.  pw_w: (C,Co)."""
    n, h, wd, _ = x.shape
    kh, kw, c = dw_w.shape
    sig = autotune.LayerSig(kind="fused_dw_pw", H=h, W=wd, C_i=c,
                            C_o=pw_w.shape[-1], K_h=kh, K_w=kw,
                            stride=stride, pad=pad,
                            dtype=autotune.dtype_name(x.dtype), N=n)
    return fused_dw_pw_conv(x, dw_w, dw_b, pw_w, pw_b, residual,
                            stride=stride, pad=pad, dw_act=dw_act,
                            pw_act=pw_act,
                            plan=autotune.resolve(sig, x.device))


def fused_inverted_residual(x: torch.Tensor, exp_w: torch.Tensor, exp_b,
                            dw_w: torch.Tensor, dw_b, proj_w: torch.Tensor,
                            proj_b, residual=None, *, stride: int = 1,
                            pad: int = 1, exp_act: str | None = "relu6",
                            dw_act: str | None = "relu6",
                            proj_act: str | None = None) -> torch.Tensor:
    """pw-expand -> dw -> pw-project fused block (MobileNet-v2 style), one
    launch of K5.  exp_w: (Ci,Cm) or (1,1,Ci,Cm); proj_w: (Cm,Co) or
    (1,1,Cm,Co)."""
    if exp_w.dim() == 4:
        exp_w = exp_w.reshape(exp_w.shape[2], exp_w.shape[3])
    if proj_w.dim() == 4:
        proj_w = proj_w.reshape(proj_w.shape[2], proj_w.shape[3])
    n, h, wd, ci = x.shape
    kh, kw, cm = dw_w.shape
    sig = autotune.LayerSig(kind="fused_pw_dw_pw", H=h, W=wd, C_i=cm,
                            C_o=proj_w.shape[1], K_h=kh, K_w=kw,
                            stride=stride, pad=pad,
                            dtype=autotune.dtype_name(x.dtype), N=n, C_e=ci)
    return fused_pw_dw_pw_conv(x, exp_w, exp_b, dw_w, dw_b, proj_w, proj_b,
                               residual, stride=stride, pad=pad,
                               exp_act=exp_act, dw_act=dw_act,
                               proj_act=proj_act,
                               plan=autotune.resolve(sig, x.device))
