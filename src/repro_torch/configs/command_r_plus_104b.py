"""command-r-plus-104b [dense]: 64L d_model=12288 96H (GQA kv=8)
d_ff=33792 vocab=256000 — GQA, no-bias
[hf:CohereForAI/c4ai-command-r-v01; unverified].

Port of ``repro/configs/command_r_plus_104b.py``: the same published widths.
"""
from repro_torch.lm.config import ArchConfig


def full() -> ArchConfig:
    """The published configuration."""
    return ArchConfig(
        name="command_r_plus_104b", family="dense",
        n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8,
        d_ff=33792, vocab=256000, qkv_bias=False,
        notes="GQA kv=8, no bias; ~104B params")


def smoke() -> ArchConfig:
    """A reduced configuration of the same family, for CPU tests."""
    return full().scaled(name="command_r_plus_104b_smoke", n_layers=2,
                         d_model=128, n_heads=8, n_kv_heads=2, d_head=16,
                         d_ff=352, vocab=512)
