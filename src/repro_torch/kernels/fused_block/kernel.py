"""Fused MobileNet blocks: dw -> pw (K4) and pw -> dw -> pw (K5), the
intermediate maps kept on chip.

Wrappers of the hand-written CUDA kernels ``csrc/fused_dw_pw_conv.cu`` and
``csrc/fused_pw_dw_pw_conv.cu``, which replace the TPU kernels
``repro/kernels/fused_block/kernel.py::fused_dw_pw_conv`` and
``::fused_pw_dw_pw_conv``; each source says what bounds it on an H100 and
how it tiles space and channels so that the intermediate maps live only in
shared memory.  ``plan.py`` chooses each call's tiling (pixel tile, cluster
size and channel split, grid, shared memory) from its shape, unless the
caller passes a plan (the plan cache's, ``kernels/autotune.py``); the
wrapper passes it to the kernel, which trusts it.

A CUDA tensor launches the kernel on the current stream (or raises); a CPU
tensor runs the plain version from ``ref.py``.  ``fused_dw_pw_conv.launches``
and ``fused_pw_dw_pw_conv.launches`` count the launches.  Both take the
paper's activations alone (``FUSED_ACTS``): their loops are compiled for
those, and an EfficientNet's layers, which take silu, never fuse.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_block.plan import plan_k4, plan_k5
from repro_torch.kernels.fused_block.ref import (fused_dw_pw_ref,
                                                 fused_pw_dw_pw_ref)
from repro_torch.kernels.util import (act_code, check_cuda_operands, counted,
                                     launch)

#: the activations K4 and K5 compute (``csrc/common.cuh``'s ``repro_act``)
FUSED_ACTS = (None, "relu", "relu6")


def _check_acts(name: str, *acts: str | None) -> None:
    for act in acts:
        if act not in FUSED_ACTS:
            raise ValueError(f"{name}: activation {act!r}; K4 and K5 take "
                             f"{FUSED_ACTS}")


def fused_dw_pw_conv(x: torch.Tensor, dw_w: torch.Tensor,
                     dw_b: torch.Tensor | None, pw_w: torch.Tensor,
                     pw_b: torch.Tensor | None,
                     residual: torch.Tensor | None = None, *,
                     stride: int = 1, pad: int = 1,
                     dw_act: str | None = "relu6",
                     pw_act: str | None = None, plan=None) -> torch.Tensor:
    """dw(KhxKw, stride) -> pw(1x1) in one launch.

    x: (N,H,W,C); dw_w: (Kh,Kw,C); pw_w: (C,Co); biases (C,)/(Co,) or None;
    residual: (N,Ho,Wo,Co) or None (added after pw_act).  ``plan``: a
    FusedPlan of this call (the plan cache's); ``plan_k4``'s pick when
    None.
    """
    if (x.dim() != 4 or dw_w.dim() != 3 or pw_w.dim() != 2
            or dw_w.shape[2] != x.shape[3] or pw_w.shape[0] != x.shape[3]):
        raise ValueError(f"fused_dw_pw_conv: x {tuple(x.shape)}, dw_w "
                         f"{tuple(dw_w.shape)}, pw_w {tuple(pw_w.shape)}")
    _check_acts("fused_dw_pw_conv", dw_act, pw_act)
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
    if plan is None:
        plan = plan_k4(n, h, wd, c, co, kh, stride, pad, kw)
    out = torch.empty((n, ho, wo, co), device=x.device, dtype=torch.float32)
    launch("repro_fused_dw_pw_conv", x.device, x, dw_w, dw_b, pw_w, pw_b,
           residual, out, n, h, wd, c, co, kh, kw, stride, pad, ho, wo,
           act_code(dw_act), act_code(pw_act), plan.th, plan.tw,
           plan.cluster, plan.stages, plan.smem_bytes,
           _vec((c, co), x, dw_w, pw_w))
    fused_dw_pw_conv.launches += 1
    return out


counted(fused_dw_pw_conv)


def fused_pw_dw_pw_conv(x: torch.Tensor, exp_w: torch.Tensor,
                        exp_b: torch.Tensor | None, dw_w: torch.Tensor,
                        dw_b: torch.Tensor | None, proj_w: torch.Tensor,
                        proj_b: torch.Tensor | None,
                        residual: torch.Tensor | None = None, *,
                        stride: int = 1, pad: int = 1,
                        exp_act: str | None = "relu6",
                        dw_act: str | None = "relu6",
                        proj_act: str | None = None,
                        plan=None) -> torch.Tensor:
    """pw-expand -> dw(KhxKw, stride) -> pw-project in one launch (the
    MobileNet v2 inverted residual; ``residual`` is added after proj_act).

    x: (N,H,W,Ci); exp_w: (Ci,Cm); dw_w: (Kh,Kw,Cm); proj_w: (Cm,Co);
    biases (Cm,)/(Cm,)/(Co,) or None; residual: (N,Ho,Wo,Co) or None.
    ``plan``: a FusedPlan of this call (the plan cache's); ``plan_k5``'s
    pick when None.
    """
    if (x.dim() != 4 or exp_w.dim() != 2 or dw_w.dim() != 3
            or proj_w.dim() != 2 or exp_w.shape[0] != x.shape[3]
            or dw_w.shape[2] != exp_w.shape[1]
            or proj_w.shape[0] != exp_w.shape[1]):
        raise ValueError(f"fused_pw_dw_pw_conv: x {tuple(x.shape)}, exp_w "
                         f"{tuple(exp_w.shape)}, dw_w {tuple(dw_w.shape)}, "
                         f"proj_w {tuple(proj_w.shape)}")
    _check_acts("fused_pw_dw_pw_conv", exp_act, dw_act, proj_act)
    n, h, wd, ci = x.shape
    kh, kw, cm = dw_w.shape
    co = proj_w.shape[1]
    ho = (h + 2 * pad - kh) // stride + 1
    wo = (wd + 2 * pad - kw) // stride + 1
    if ho < 1 or wo < 1:
        raise ValueError(f"fused_pw_dw_pw_conv: empty output {ho}x{wo}")
    for key, t, shape in (("exp_b", exp_b, (cm,)), ("dw_b", dw_b, (cm,)),
                          ("proj_b", proj_b, (co,)),
                          ("residual", residual, (n, ho, wo, co))):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"fused_pw_dw_pw_conv: {key} "
                             f"{tuple(t.shape)}, expected {shape}")
    if x.device.type == "cpu":
        return fused_pw_dw_pw_ref(x, exp_w, exp_b, dw_w, dw_b, proj_w,
                                  proj_b, residual, stride=stride, pad=pad,
                                  exp_act=exp_act, dw_act=dw_act,
                                  proj_act=proj_act)
    check_cuda_operands("fused_pw_dw_pw_conv", x.device, x=x, exp_w=exp_w,
                        exp_b=exp_b, dw_w=dw_w, dw_b=dw_b, proj_w=proj_w,
                        proj_b=proj_b, residual=residual)
    if plan is None:
        plan = plan_k5(n, h, wd, ci, cm, co, kh, stride, pad, kw)
    out = torch.empty((n, ho, wo, co), device=x.device, dtype=torch.float32)
    launch("repro_fused_pw_dw_pw_conv", x.device, x, exp_w, exp_b, dw_w,
           dw_b, proj_w, proj_b, residual, out, n, h, wd, ci, cm, co, kh,
           kw, stride, pad, ho, wo, act_code(exp_act), act_code(dw_act),
           act_code(proj_act), plan.th, plan.tw, plan.cluster, plan.stages,
           plan.kc, plan.group, plan.smem_bytes,
           _vec((ci, cm, co), x, exp_w, dw_w, proj_w))
    fused_pw_dw_pw_conv.launches += 1
    return out


counted(fused_pw_dw_pw_conv)


def _vec(channels: tuple[int, ...], *staged: torch.Tensor) -> int:
    """1 if the kernel may stage with 16-byte copies: every channel count a
    multiple of 4 and every staged tensor 16-byte aligned; else 0 (4-byte
    copies)."""
    return int(all(c % 4 == 0 for c in channels)
               and all(t.data_ptr() % 16 == 0 for t in staged))
