"""The model's work, counted from its layer table, and the card's peaks.

A request's FLOPs are twice its multiply-adds: the sum of its table
entries' ``flops`` (every conv, depthwise conv and the classifier; an
entry of a reference's own class counts its own).  Its byte floor counts
the images, the weights and the logits once each; activations between
layers are left out, since a fused kernel need never write them, so no
fusion can carry a share of the bound past 100%.  Nothing here reads the
program's plans or kernels.
"""
from __future__ import annotations

from bench.reference.plain import Entry

#: published peaks by ``torch.cuda.get_device_name()``: NVIDIA's H100 SXM
#: data sheet, dense, at its 700 W limit.  ``flops`` is the float32-
#: accurate rate: 495 TF32 TFLOP/s over the three TF32 products of the
#: 3xTF32 split (no f32-accurate path of the card runs faster).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"flops": 495e12 / 3, "bytes": 3.35e12,
                              "power_limit_w": 700.0},
}


def flops_per_image(table: list[Entry]) -> int:
    """FLOPs of one image through ``table``."""
    return sum(l.flops for l in table)


def weight_bytes(table: list[Entry]) -> int:
    """Bytes of every weight and bias, in float32."""
    n = 0
    for l in table:
        w = 1
        for d in l.weight_shape():
            w *= d
        n += w + l.c_out
    return 4 * n


def request_bytes(table: list[Entry], batch: int, image_px: int,
                  channels: int) -> int:
    """Byte floor of one request: its images, the weights, its logits."""
    images = batch * image_px * image_px * channels * 4
    return images + weight_bytes(table) + batch * table[-1].c_out * 4


def bound_s(flops: float, nbytes: float, kind: str) -> float | None:
    """Least seconds the card ``kind`` needs for the work (None: a card
    this table has no peaks of)."""
    peak = PEAKS.get(kind)
    if peak is None:
        return None
    return max(flops / peak["flops"], nbytes / peak["bytes"])
