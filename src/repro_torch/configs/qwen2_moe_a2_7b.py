"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=151936, MoE 60e top-4 — 4 shared + 60 routed top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf].

Port of ``repro/configs/qwen2_moe_a2_7b.py``: the same published widths.
"""
from repro_torch.lm.config import ArchConfig


def full() -> ArchConfig:
    """The published configuration."""
    return ArchConfig(
        name="qwen2_moe_a2_7b", family="moe",
        n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1408, vocab=151936, qkv_bias=True,
        moe_experts=60, moe_top_k=4, moe_shared=4)


def smoke() -> ArchConfig:
    """A reduced configuration of the same family, for CPU tests."""
    return full().scaled(name="qwen2_moe_a2_7b_smoke", n_layers=2,
                         d_model=128, n_heads=4, n_kv_heads=4, d_head=32,
                         d_ff=96, vocab=512, moe_experts=8, moe_top_k=2,
                         moe_shared=1)
