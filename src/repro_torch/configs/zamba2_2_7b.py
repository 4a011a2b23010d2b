"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (GQA kv=32) d_ff=10240
vocab=32000, ssm_state=64 — Mamba2 backbone + shared attn block
[arXiv:2411.15242; hf].

Port of ``repro/configs/zamba2_2_7b.py``: the same published widths.
"""
from repro_torch.lm.config import ArchConfig


def full() -> ArchConfig:
    """The published configuration."""
    return ArchConfig(
        name="zamba2_2_7b", family="hybrid",
        n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
        d_ff=10240, vocab=32000,
        block_type="mamba2", ssm_state=64, attn_every=6,
        notes="Mamba2 layers; one weight-shared attn+MLP block applied "
              "every 6 layers (9 applications)")


def smoke() -> ArchConfig:
    """A reduced configuration of the same family, for CPU tests."""
    return full().scaled(name="zamba2_2_7b_smoke", n_layers=4, d_model=128,
                         n_heads=4, n_kv_heads=4, d_head=32, d_ff=256,
                         vocab=512, ssm_state=16, attn_every=2)
