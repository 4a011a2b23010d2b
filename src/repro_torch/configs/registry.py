"""Registry of the architectures the port can run.

Port of ``repro/configs/registry.py``: the reference's ten LM
architectures, the four dense transformers, the two MoE transformers,
xLSTM (mLSTM blocks), Zamba2 (Mamba2 with a shared attention block),
Whisper (encoder-decoder) and Qwen2-VL (M-RoPE).  Granite-20B (113 GB of
f32 weights), Command R+ (428 GB) and Qwen2-VL-72B (291 GB) do not fit one
80 GB card at full depth; they are registered for their configs and
their smoke widths.  Asking for another name raises ``KeyError`` naming
the ones the port has.
"""
from __future__ import annotations

import importlib

ARCH_IDS = ("qwen2_0_5b", "qwen2_5_14b", "granite_20b",
            "command_r_plus_104b", "qwen2_moe_a2_7b", "granite_moe_3b_a800m",
            "xlstm_350m", "zamba2_2_7b", "whisper_small", "qwen2_vl_72b")

CNN_IDS = ("mobilenet_v1", "mobilenet_v2", "squeezenet")


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
