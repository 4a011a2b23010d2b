"""Plain PyTorch versions of the conv_gemm kernels (K1, K3).

Counterpart of ``repro/kernels/conv_gemm/ref.py``.  These run the kernels'
arithmetic in ordinary tensor ops: the CPU tests use them, the wrappers in
``kernel.py`` take them for CPU tensors, and ``chip_smoke.py`` holds the
CUDA kernels against them on the card.  ``conv2d_ref`` is ``im2col`` then
one GEMM over the (i, j, c)-ordered patch matrix, the reduction the
implicit-GEMM kernel walks without ever materializing the matrix.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.util import apply_act


def matmul_bias_act_ref(x: torch.Tensor, w: torch.Tensor,
                        bias: torch.Tensor | None = None,
                        act: str | None = None) -> torch.Tensor:
    """(M, K) @ (K, N) + bias, then the activation, in float32."""
    out = torch.matmul(x.float(), w.float())
    if bias is not None:
        out = out + bias.float()
    return apply_act(out, act)


def im2col(x: torch.Tensor, kh: int, kw: int, stride: int,
           pad: int) -> tuple[torch.Tensor, tuple[int, int, int]]:
    """NHWC -> (N*Ho*Wo, kh*kw*C) patch matrix, taps in (i, j, c) order."""
    n, h, w, c = x.shape
    xp = F.pad(x, (0, 0, pad, pad, pad, pad))
    ho = (h + 2 * pad - kh) // stride + 1
    wo = (w + 2 * pad - kw) // stride + 1
    patches = [xp[:, i:i + (ho - 1) * stride + 1:stride,
                  j:j + (wo - 1) * stride + 1:stride, :]
               for i in range(kh) for j in range(kw)]   # each (n, ho, wo, c)
    pm = torch.stack(patches, dim=3)                    # (n, ho, wo, kh*kw, c)
    return pm.reshape(n * ho * wo, kh * kw * c), (n, ho, wo)


def conv2d_ref(x: torch.Tensor, w: torch.Tensor,
               bias: torch.Tensor | None = None, stride: int = 1,
               pad: int = 0, act: str | None = None) -> torch.Tensor:
    """NHWC conv with an HWIO weight, bias and activation."""
    kh, kw, ci, co = w.shape
    pm, (n, ho, wo) = im2col(x, kh, kw, stride, pad)
    out = matmul_bias_act_ref(pm, w.reshape(kh * kw * ci, co), bias, act)
    return out.reshape(n, ho, wo, co)
