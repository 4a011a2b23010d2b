"""Architecture config for the LM-family models.

Port of ``repro/lm/config.py``, copied with its derived properties: one
frozen dataclass covers all five families (dense / moe / hybrid / enc-dec /
recurrent); family-specific fields are zero/None when unused.  The port
runs every family; its instances live in
``repro_torch.configs.<arch_id>`` and are registered in
``repro_torch.configs.registry``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | hybrid | audio | vlm | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0             # 0 -> d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    rope_theta: float = 1e4
    # --- MoE ---------------------------------------------------------------
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_shared: int = 0         # always-on shared experts (DeepSeek/Qwen-MoE)
    moe_capacity_factor: float = 1.25
    # token counts <= this use the dense all-experts path (decode: reading
    # every expert's weights dominates anyway, so dense compute is free)
    moe_dense_threshold: int = 512
    # --- SSM / hybrid ------------------------------------------------------
    block_type: str = "transformer"   # transformer | mamba2 | mlstm
    ssm_state: int = 0
    ssm_conv: int = 4
    d_inner_mult: int = 2       # d_inner = mult * d_model for ssm blocks
    attn_every: int = 0         # hybrid: shared attn block every k layers
    # --- enc-dec (whisper) ---------------------------------------------------
    encoder_decoder: bool = False
    enc_layers: int = 0
    enc_positions: int = 1500   # whisper: 1500 frames after the conv stem
    # --- multimodal ----------------------------------------------------------
    mrope: bool = False         # qwen2-vl M-RoPE (3 rotary sections)
    mrope_sections: tuple = (16, 24, 24)   # t/h/w split of d_head//2
    frontend: str | None = None  # 'audio' | 'vision' stub (input_specs emits
    #                              precomputed frame/patch embeddings)
    notes: str = ""

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        assert self.n_heads % 1 == 0
        if self.family == "moe":
            assert self.moe_experts > 0 and self.moe_top_k > 0

    # ---- derived ----------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """LM-head vocab padded to a TP-shardable multiple (Megatron-style):
        keeps logits (vocab -> 'model')-sharded even for vocabs like
        whisper's 51865 or granite-moe's 49155.  Padded logit columns are
        masked to -inf in the loss / argmax."""
        mult = 2048
        return -(-self.vocab // mult) * mult

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.d_head

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.d_head

    @property
    def d_inner(self) -> int:
        return self.d_inner_mult * self.d_model

    @property
    def ssm_heads(self) -> int:
        """Mamba2/mLSTM head count over d_inner (headdim 64 convention)."""
        return max(1, self.d_inner // 64)

    def param_count(self) -> int:
        """Analytic parameter count (used for roofline MODEL_FLOPS=6ND)."""
        d, v = self.d_model, self.vocab
        total = v * d                      # embedding
        if not self.tie_embeddings:
            total += d * v                 # lm head
        per_layer = 0
        if self.block_type == "transformer":
            per_layer += d * self.q_dim + 2 * d * self.kv_dim \
                + self.q_dim * d           # qkvo
            if self.qkv_bias:
                per_layer += self.q_dim + 2 * self.kv_dim
            per_layer += 2 * d             # norms
            if self.family == "moe":
                per_layer += d * self.moe_experts        # router
                per_layer += 3 * d * self.d_ff * (self.moe_experts
                                                  + self.moe_shared)
            else:
                per_layer += 3 * d * self.d_ff           # swiglu
        elif self.block_type == "mamba2":
            din, st, nh = self.d_inner, self.ssm_state, self.ssm_heads
            per_layer += d * (2 * din + 2 * st + nh)     # in_proj
            per_layer += self.ssm_conv * (din + 2 * st)  # conv1d
            per_layer += nh * 2 + din                    # A, D, dt_bias-ish
            per_layer += din * d + d                     # out_proj + norm
        elif self.block_type == "mlstm":
            din = self.d_inner
            per_layer += d * 3 * din + d * 2 * self.ssm_heads  # qkv + i/f
            per_layer += din * d + 2 * d                       # out + norms
        total += self.n_layers * per_layer
        if self.attn_every:                # zamba2 shared attn+mlp block
            total += (d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
                      + 3 * d * self.d_ff + 2 * d)
        if self.encoder_decoder:
            enc_per = (4 * d * d + 3 * d * self.d_ff + 2 * d)
            dec_cross = self.n_layers * (4 * d * d + d)
            total += self.enc_layers * enc_per + dec_cross
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE uses top_k + shared experts only)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        dense = self.param_count() - self.n_layers * 3 * d * self.d_ff * (
            self.moe_experts + self.moe_shared)
        active = self.n_layers * 3 * d * self.d_ff * (self.moe_top_k
                                                      + self.moe_shared)
        return int(dense + active)

    def scaled(self, **overrides) -> "ArchConfig":
        """Reduced-config clone for smoke tests."""
        return dataclasses.replace(self, **overrides)
