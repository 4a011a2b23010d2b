"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40e top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base; hf].

Port of ``repro/configs/granite_moe_3b_a800m.py``: the same published
widths.
"""
from repro_torch.lm.config import ArchConfig


def full() -> ArchConfig:
    """The published configuration."""
    return ArchConfig(
        name="granite_moe_3b_a800m", family="moe",
        n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
        d_ff=512, vocab=49155,
        moe_experts=40, moe_top_k=8, moe_shared=0,
        notes="vocab 49155 not divisible by 16 -> vocab axis falls back "
              "to replicated (DESIGN.md §5)")


def smoke() -> ArchConfig:
    """A reduced configuration of the same family, for CPU tests."""
    return full().scaled(name="granite_moe_3b_a800m_smoke", n_layers=2,
                         d_model=96, n_heads=6, n_kv_heads=2, d_head=16,
                         d_ff=64, vocab=515, moe_experts=8, moe_top_k=2)
