"""Plain PyTorch versions of the fused-block kernels (K4, K5).

Counterpart of ``repro/kernels/fused_block/ref.py``: the composed unfused
ops (pointwise GEMMs, depthwise, then the residual), which is what the
fused kernels must reproduce.  The depthwise pads the expanded map after
its bias and activation, so the pad reads 0.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.conv_gemm.ref import matmul_bias_act_ref
from repro_torch.kernels.depthwise.ref import depthwise_conv2d_ref


def fused_dw_pw_ref(x: torch.Tensor, dw_w: torch.Tensor,
                    dw_b: torch.Tensor | None, pw_w: torch.Tensor,
                    pw_b: torch.Tensor | None,
                    residual: torch.Tensor | None = None, *,
                    stride: int = 1, pad: int = 1,
                    dw_act: str | None = "relu6",
                    pw_act: str | None = None) -> torch.Tensor:
    """dw(KhxKw, stride) -> act -> pw(1x1) -> act (+ residual).

    x: (N,H,W,C); dw_w: (Kh,Kw,C); pw_w: (C,Co); residual: (N,Ho,Wo,Co).
    """
    h = depthwise_conv2d_ref(x, dw_w, dw_b, stride=stride, pad=pad,
                             act=dw_act)
    n, ho, wo, c = h.shape
    co = pw_w.shape[1]
    out = matmul_bias_act_ref(h.reshape(n * ho * wo, c), pw_w, pw_b,
                              pw_act).reshape(n, ho, wo, co)
    if residual is not None:
        out = out + residual
    return out


def fused_pw_dw_pw_ref(x: torch.Tensor, exp_w: torch.Tensor,
                       exp_b: torch.Tensor | None, dw_w: torch.Tensor,
                       dw_b: torch.Tensor | None, proj_w: torch.Tensor,
                       proj_b: torch.Tensor | None,
                       residual: torch.Tensor | None = None, *,
                       stride: int = 1, pad: int = 1,
                       exp_act: str | None = "relu6",
                       dw_act: str | None = "relu6",
                       proj_act: str | None = None) -> torch.Tensor:
    """pw-expand -> act -> dw(KhxKw, stride) -> act -> pw-project -> act
    (+ residual).

    x: (N,H,W,Ci); exp_w: (Ci,Cm); dw_w: (Kh,Kw,Cm); proj_w: (Cm,Co);
    residual: (N,Ho,Wo,Co).
    """
    n, h, wd, ci = x.shape
    cm = exp_w.shape[1]
    e = matmul_bias_act_ref(x.reshape(n * h * wd, ci), exp_w, exp_b,
                            exp_act).reshape(n, h, wd, cm)
    return fused_dw_pw_ref(e, dw_w, dw_b, proj_w, proj_b, residual,
                           stride=stride, pad=pad, dw_act=dw_act,
                           pw_act=proj_act)
