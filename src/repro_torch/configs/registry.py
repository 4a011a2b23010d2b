"""Registry of the architectures the port can run.

Port of ``repro/configs/registry.py``.  The reference registers ten LM
architectures; the port lists those whose blocks it has: the four dense
transformers and the two MoE transformers.  Granite-20B (113 GB of f32
weights) and Command R+ (428 GB) do not fit one 80 GB card at full depth;
they are registered for their configs and their smoke widths.  Asking
for an SSM, hybrid, encoder-decoder or M-RoPE architecture raises
``KeyError`` naming the ones the port has.
"""
from __future__ import annotations

import importlib

ARCH_IDS = ("qwen2_0_5b", "qwen2_5_14b", "granite_20b",
            "command_r_plus_104b", "qwen2_moe_a2_7b", "granite_moe_3b_a800m")

CNN_IDS = ("mobilenet_v1", "mobilenet_v2", "squeezenet")


def _module(name: str):
    if name not in ARCH_IDS:
        raise KeyError(f"architecture {name!r} is not in the port; the port "
                       f"has {ARCH_IDS} (the other blocks are ROADMAP queue "
                       f"1 item 6.4)")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_arch(name: str):
    """The published configuration of ``name``."""
    return _module(name).full()


def get_smoke(name: str):
    """The reduced configuration of ``name`` (CPU tests)."""
    return _module(name).smoke()
