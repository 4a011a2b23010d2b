"""qwen2.5-14b [dense]: 48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064 — GQA, QKV bias [hf:Qwen/Qwen2.5-0.5B; hf].

Port of ``repro/configs/qwen2_5_14b.py``: the same published widths.
"""
from repro_torch.lm.config import ArchConfig


def full() -> ArchConfig:
    """The published configuration."""
    return ArchConfig(
        name="qwen2_5_14b", family="dense",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=13824, vocab=152064, qkv_bias=True, rope_theta=1e6)


def smoke() -> ArchConfig:
    """A reduced configuration of the same family, for CPU tests."""
    return full().scaled(name="qwen2_5_14b_smoke", n_layers=2, d_model=160,
                         n_heads=10, n_kv_heads=2, d_head=16, d_ff=432,
                         vocab=512)
