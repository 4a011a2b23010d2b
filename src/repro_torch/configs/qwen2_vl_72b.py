"""qwen2-vl-72b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 — M-RoPE, dynamic resolution; vision frontend STUB
(precomputed patch embeddings) [arXiv:2409.12191; hf].

Port of ``repro/configs/qwen2_vl_72b.py``: the same published widths.
"""
from repro_torch.lm.config import ArchConfig


def full() -> ArchConfig:
    """The published configuration."""
    return ArchConfig(
        name="qwen2_vl_72b", family="vlm",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=29568, vocab=152064, qkv_bias=True, rope_theta=1e6,
        mrope=True, mrope_sections=(16, 24, 24), frontend="vision",
        notes="M-RoPE over (t,h,w) position streams; patch embeddings "
              "stubbed per assignment")


def smoke() -> ArchConfig:
    """A reduced configuration of the same family, for CPU tests."""
    return full().scaled(name="qwen2_vl_72b_smoke", n_layers=2, d_model=128,
                         n_heads=8, n_kv_heads=2, d_head=16, d_ff=320,
                         vocab=512, mrope_sections=(2, 3, 3))
