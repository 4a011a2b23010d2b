"""qwen2-0.5b [dense]: 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151936, QKV bias [arXiv:2407.10671; hf].

Port of ``repro/configs/qwen2_0_5b.py``: the same published widths.
"""
from repro_torch.lm.config import ArchConfig


def full() -> ArchConfig:
    """The published configuration."""
    return ArchConfig(
        name="qwen2_0_5b", family="dense",
        n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
        d_ff=4864, vocab=151936, qkv_bias=True, tie_embeddings=True,
        rope_theta=1e6,
        notes="QKV bias; 14 heads do not divide a 16-way model axis -> "
              "sharding falls back per DESIGN.md §5")


def smoke() -> ArchConfig:
    """A reduced configuration of the same family, for CPU tests."""
    return full().scaled(name="qwen2_0_5b_smoke", n_layers=2, d_model=112,
                         n_heads=14, n_kv_heads=2, d_head=8, d_ff=304,
                         vocab=512)
