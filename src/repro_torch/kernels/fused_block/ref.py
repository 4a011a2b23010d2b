"""Plain PyTorch version of the fused dw -> pw kernel (K4).

Counterpart of ``repro/kernels/fused_block/ref.py``: the composed unfused
ops (depthwise, then the pointwise GEMM, then the residual), which is what
the fused kernel must reproduce.
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
