"""xlstm-350m [ssm]: 24L d_model=1024 4H d_ff=0 vocab=50304 — sLSTM +
mLSTM blocks [arXiv:2405.04517; unverified].  Built of mLSTM blocks only,
as the reference builds it (the 350M xLSTM is predominantly mLSTM).

Port of ``repro/configs/xlstm_350m.py``: the same published widths.
"""
from repro_torch.lm.config import ArchConfig


def full() -> ArchConfig:
    """The published configuration."""
    return ArchConfig(
        name="xlstm_350m", family="ssm",
        n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab=50304,
        block_type="mlstm", ssm_state=64, d_inner_mult=2,
        notes="d_ff=0: blocks carry their own 2x up-projection")


def smoke() -> ArchConfig:
    """A reduced configuration of the same family, for CPU tests."""
    return full().scaled(name="xlstm_350m_smoke", n_layers=2, d_model=128,
                         n_heads=4, n_kv_heads=4, d_head=32, vocab=512)
