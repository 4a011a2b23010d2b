"""Registry of the architectures the port can run.

Port of ``repro/configs/registry.py``: the reference's ten LM
architectures, the four dense transformers, the two MoE transformers,
xLSTM (mLSTM blocks), Zamba2 (Mamba2 with a shared attention block),
Whisper (encoder-decoder) and Qwen2-VL (M-RoPE), in the reference's
order.  Granite-20B (113 GB of f32 weights), Command R+ (428 GB) and
Qwen2-VL-72B (291 GB) do not fit one 80 GB card at full depth; they are
registered for their configs and their smoke widths.  Asking for another
name raises ``KeyError`` naming the ones the port has.  ``SHAPES``,
``LONG_OK`` and ``cells`` are the reference's dry-run cells
(``launch/dryrun.py``).
"""
from __future__ import annotations

import importlib

ARCH_IDS = (
    "command_r_plus_104b",
    "granite_20b",
    "qwen2_0_5b",
    "qwen2_5_14b",
    "qwen2_moe_a2_7b",
    "granite_moe_3b_a800m",
    "zamba2_2_7b",
    "whisper_small",
    "qwen2_vl_72b",
    "xlstm_350m",
)

CNN_IDS = ("mobilenet_v1", "mobilenet_v2", "squeezenet")

# (seq_len, global_batch, kind); kind: train | prefill | decode | long-decode
SHAPES = {
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "long-decode"),
}

# long_500k runs only for the architectures whose state does not grow with
# the sequence: the others would stream a dense KV cache of 524k positions
LONG_OK = ("zamba2_2_7b", "xlstm_350m")


def _module(name: str):
    if name not in ARCH_IDS:
        raise KeyError(f"unknown architecture {name!r}; the port has "
                       f"{ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_arch(name: str):
    """The published configuration of ``name``."""
    return _module(name).full()


def get_smoke(name: str):
    """The reduced configuration of ``name`` (CPU tests)."""
    return _module(name).smoke()


def cells(include_long: bool = True):
    """Every live (arch, shape) dry-run cell, in the reference's order.
    ``include_long`` is the reference's argument, which it does not read
    either: ``long_500k`` is a cell of the ``LONG_OK`` architectures."""
    out = []
    for a in ARCH_IDS:
        for s in SHAPES:
            if s == "long_500k" and a not in LONG_OK:
                continue
            out.append((a, s))
    return out
