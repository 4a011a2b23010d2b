"""granite-20b [dense]: 52L d_model=6144 48H (GQA kv=1 == MQA) d_ff=24576
vocab=49152 — llama-arch, code [arXiv:2405.04324; hf].

Port of ``repro/configs/granite_20b.py``: the same published widths.
"""
from repro_torch.lm.config import ArchConfig


def full() -> ArchConfig:
    """The published configuration."""
    return ArchConfig(
        name="granite_20b", family="dense",
        n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1,
        d_ff=24576, vocab=49152,
        notes="MQA (kv=1): the most memory-bound decode of the pool")


def smoke() -> ArchConfig:
    """A reduced configuration of the same family, for CPU tests."""
    return full().scaled(name="granite_20b_smoke", n_layers=2, d_model=96,
                         n_heads=6, n_kv_heads=1, d_head=16, d_ff=384,
                         vocab=512)
