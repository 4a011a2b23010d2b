"""c-core analogue: the tiled GEMM (K1) and the implicit-GEMM conv (K3).

Wrappers of the hand-written CUDA kernels ``csrc/matmul_bias_act.cu`` and
``csrc/conv2d_implicit_gemm.cu``, which replace the TPU kernels
``repro/kernels/conv_gemm/kernel.py::matmul_bias_act`` and
``::conv2d_implicit_gemm``; each source says what bounds the kernel on an
H100 and what its design does about it.  ``plan.py`` chooses each K1 and
K3 call's tiling (output tile, k-step, warp layout, cluster and K split,
shared memory) from its shape, unless the caller passes a plan (the plan
cache's, ``kernels/autotune.py``); the wrapper passes it to the kernel,
which trusts it.

A wrapper dispatches on the device of its input: a CUDA tensor launches the
kernel on the current stream (or raises), a CPU tensor runs the plain
version from ``ref.py``.  Each wrapper counts its launches in its
``launches`` attribute, a plain integer, incremented only where the kernel
is launched.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.conv_gemm.plan import plan_k1, plan_k3
from repro_torch.kernels.conv_gemm.ref import conv2d_ref, matmul_bias_act_ref
from repro_torch.kernels.util import (act_code, check_cuda_operands, counted,
                                     launch)


def matmul_bias_act(x: torch.Tensor, w: torch.Tensor,
                    bias: torch.Tensor | None = None, *,
                    act: str | None = None, plan=None) -> torch.Tensor:
    """(M, K) @ (K, N) + bias with a fused relu/relu6, in float32 (K1).
    ``plan``: a :class:`~repro_torch.kernels.conv_gemm.plan.GemmPlan` of
    this shape (the plan cache's); ``plan_k1``'s pick when None."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul_bias_act: shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[1]
    if bias is not None and tuple(bias.shape) != (n,):
        raise ValueError(f"matmul_bias_act: bias {tuple(bias.shape)}, "
                         f"expected ({n},)")
    if x.device.type == "cpu":
        return matmul_bias_act_ref(x, w, bias, act)
    check_cuda_operands("matmul_bias_act", x.device, x=x, w=w, bias=bias)
    if plan is None:
        plan = plan_k1(m, k, n)
    out = torch.empty((m, n), device=x.device, dtype=torch.float32)
    vec = (int(k % 4 == 0 and x.data_ptr() % 16 == 0)
           | 2 * int(n % 4 == 0 and w.data_ptr() % 16 == 0))
    launch("repro_matmul_bias_act", x.device, x, w, bias, out, m, n, k,
           act_code(act), plan.bm, plan.bn, plan.bk, plan.wm, plan.cluster,
           plan.stages, plan.smem_bytes, vec)
    matmul_bias_act.launches += 1
    return out


counted(matmul_bias_act)


def conv2d_implicit_gemm(x: torch.Tensor, w: torch.Tensor,
                         bias: torch.Tensor | None = None, *,
                         stride: int = 1, pad: int = 0,
                         act: str | None = None, plan=None) -> torch.Tensor:
    """NHWC KxK conv as an implicit GEMM (K3): patch rows are gathered
    per output tile from the unpadded input, never stored.

    x: (N, H, W, C_i); w: (K_h, K_w, C_i, C_o); bias: (C_o,) or None.
    ``plan``: a GemmPlan of this call (the plan cache's), made for its
    staging (16-byte copies where Ci % 4 == 0 and x is 16-byte aligned);
    ``plan_k3``'s pick when None.
    """
    if x.dim() != 4 or w.dim() != 4 or x.shape[3] != w.shape[2]:
        raise ValueError(f"conv2d_implicit_gemm: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    n, h, wd, ci = x.shape
    kh, kw, _, co = w.shape
    if bias is not None and tuple(bias.shape) != (co,):
        raise ValueError(f"conv2d_implicit_gemm: bias {tuple(bias.shape)}, "
                         f"expected ({co},)")
    ho = (h + 2 * pad - kh) // stride + 1
    wo = (wd + 2 * pad - kw) // stride + 1
    if ho < 1 or wo < 1:
        raise ValueError(f"conv2d_implicit_gemm: empty output {ho}x{wo}")
    if x.device.type == "cpu":
        return conv2d_ref(x, w, bias, stride=stride, pad=pad, act=act)
    check_cuda_operands("conv2d_implicit_gemm", x.device, x=x, w=w,
                        bias=bias)
    va = ci % 4 == 0 and x.data_ptr() % 16 == 0
    if plan is None:
        plan = plan_k3(n, h, wd, ci, co, kh, kw, stride, pad, va)
    out = torch.empty((n, ho, wo, co), device=x.device, dtype=torch.float32)
    vec = int(va) | 2 * int(co % 4 == 0 and w.data_ptr() % 16 == 0)
    launch("repro_conv2d_implicit_gemm", x.device, x, w, bias, out, n, h, wd,
           ci, co, kh, kw, stride, pad, ho, wo, act_code(act), plan.bm,
           plan.bn, plan.bk, plan.wm, plan.cluster, plan.stages,
           plan.smem_bytes, vec)
    conv2d_implicit_gemm.launches += 1
    return out


counted(conv2d_implicit_gemm)
