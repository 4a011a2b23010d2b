"""whisper-small [audio]: 12L d_model=768 12H d_ff=3072 vocab=51865 —
enc-dec, conv frontend STUB (1500 precomputed frame embeddings)
[arXiv:2212.04356; unverified].

Port of ``repro/configs/whisper_small.py``: the same published widths.
"""
from repro_torch.lm.config import ArchConfig


def full() -> ArchConfig:
    """The published configuration."""
    return ArchConfig(
        name="whisper_small", family="audio",
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
        d_ff=3072, vocab=51865,
        encoder_decoder=True, enc_layers=12, enc_positions=1500,
        frontend="audio",
        notes="conv frontend stubbed per assignment; decoder cross-attends "
              "to 1500 frame embeddings")


def smoke() -> ArchConfig:
    """A reduced configuration of the same family, for CPU tests."""
    return full().scaled(name="whisper_small_smoke", n_layers=2,
                         enc_layers=2, d_model=96, n_heads=6, n_kv_heads=6,
                         d_head=16, d_ff=192, vocab=512, enc_positions=50)
