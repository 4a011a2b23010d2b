"""A layer table run in plain PyTorch: the benchmark's reference forward.

Activations are NCHW inside and the input is NHWC, as served; weights come
in the served layouts (HWIO for a conv and the classifier, ``(Kh, Kw, C)``
for a depthwise conv) and are reordered here.  ``precision="f32"`` is the
reference: float32 with TF32 switched off for the call.  ``"tf32"`` is the
control: every conv's and the classifier's operands rounded to TF32 (10
mantissa bits, to nearest even) and then multiplied in float32, which is
what a TF32 tensor-core product computes, on any device;
``"tf32_library"`` lets cuBLAS and cuDNN take their own TF32 paths
instead (on a card only).

A reference module ``reference/<name>.py`` gives ``layers(cfg)``, a table
of :class:`Entry`.  It may also define its own ``forward(table, params,
x, precision="f32")`` with :func:`forward`'s contract: NHWC float32
images in, logits ``(N, classes)`` out, weights in the served layouts,
and the three precisions of ``PRECISIONS``; such a forward reuses
:func:`to_tf32`, :func:`tf32_products` and :func:`layer_forward`.  The
harness uses a module's own forward for the output check and the control
where it has one, this module's :func:`forward` where it has none
(``bench.harness.check.forward_of``).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Protocol, runtime_checkable

import torch
import torch.nn.functional as F


@runtime_checkable
class Entry(Protocol):
    """What the harness reads from each entry of a layer table, whatever
    its class: ``inputs.make_params`` draws one weight of
    ``weight_shape()``, He-scaled by ``fan_in``, and one bias of
    ``c_out`` for each entry, under its ``name``; ``work`` sums ``flops``
    and the weights' and biases' bytes; the last entry's ``c_out`` is the
    number of classes.  :class:`Layer` is one; a reference with layer
    kinds of its own (an SE gate's reduce and expand FCs) defines its own
    class with these members."""

    @property
    def name(self) -> str: ...

    @property
    def c_out(self) -> int: ...

    def weight_shape(self) -> tuple[int, ...]: ...

    @property
    def fan_in(self) -> int: ...

    @property
    def flops(self) -> int: ...


@dataclasses.dataclass(frozen=True)
class Layer:
    """One layer: a conv (``op="conv"``), a depthwise conv (``"dw"``) or
    the classifier (``"fc"``, after a global average pool).  ``h`` is the
    input's height and width.  ``stash`` keeps the layer's input for a
    residual; ``add`` adds the stash to the layer's output."""

    name: str
    op: str
    h: int
    c_in: int
    c_out: int
    k: int = 1
    stride: int = 1
    pad: int = 0
    act: str | None = "relu6"
    stash: bool = False
    add: bool = False

    @property
    def h_out(self) -> int:
        """Output height and width (1 for the classifier)."""
        if self.op == "fc":
            return 1
        return (self.h + 2 * self.pad - self.k) // self.stride + 1

    def weight_shape(self) -> tuple[int, ...]:
        """The served layout of the weight."""
        if self.op == "dw":
            return (self.k, self.k, self.c_in)
        return (self.k, self.k, self.c_in, self.c_out)

    @property
    def fan_in(self) -> int:
        """Inputs a weight of one output sums over (He scaling)."""
        return self.k * self.k * (1 if self.op == "dw" else self.c_in)

    @property
    def flops(self) -> int:
        """Multiply-adds of one image, times 2."""
        macs = self.h_out * self.h_out * self.k * self.k * self.c_out
        return 2 * macs * (1 if self.op == "dw" else self.c_in)


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to TF32's 10 mantissa bits, to nearest
    even, kept in float32."""
    i = t.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


PRECISIONS = ("f32", "tf32", "tf32_library")


@contextlib.contextmanager
def tf32_products(allow: bool):
    """TF32 allowed (or not) for cuBLAS's and cuDNN's float32 products."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _act(x: torch.Tensor, act: str | None) -> torch.Tensor:
    if act is None:
        return x
    if act == "relu6":
        return x.clamp(0.0, 6.0)
    if act == "relu":
        return x.clamp_min(0.0)
    raise ValueError(f"unknown activation {act!r}")


def layer_forward(l: Layer, x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor, precision: str) -> torch.Tensor:
    """One layer on NCHW ``x`` (the classifier: after the pool)."""
    if precision == "tf32":
        x, w = to_tf32(x), to_tf32(w)
    if l.op == "conv":
        y = F.conv2d(x, w.permute(3, 2, 0, 1), b, stride=l.stride,
                     padding=l.pad)
    elif l.op == "dw":
        y = F.conv2d(x, w.permute(2, 0, 1).unsqueeze(1), b,
                     stride=l.stride, padding=l.pad, groups=l.c_in)
    elif l.op == "fc":
        y = x @ w.reshape(l.c_in, l.c_out) + b
    else:
        raise ValueError(f"unknown op {l.op!r}")
    return _act(y, l.act)


def forward(table: list[Layer], params: dict, x: torch.Tensor,
            precision: str = "f32") -> torch.Tensor:
    """Logits ``(N, classes)`` of NHWC images ``x`` through ``table``,
    with ``params[name] = {"w", "b"}`` in the served layouts."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    with tf32_products(precision == "tf32_library"):
        h = x.permute(0, 3, 1, 2).float()
        res = None
        for l in table:
            if l.stash:
                res = h
            if l.op == "fc":
                h = h.mean(dim=(2, 3))
            p = params[l.name]
            h = layer_forward(l, h, p["w"], p["b"], precision)
            if l.add:
                h = h + res
        return h
