"""Analytic HBM-traffic model for the roofline memory term.

Port of ``repro/launch/roofline_model.py``, plain arithmetic on
``ArchConfig``, kept as the port's own copy.  Counting discipline (per
device, per step):

  train:   weights stream fwd + remat-recompute + bwd (3x) per microbatch;
           grads/optimizer state read+write in fp32; activation residual
           traffic ~ 12 bytes/token/layer/d_model (bf16 in+out per block,
           norm reads, remat saves).
  prefill: weights once; activations 6 B/token/layer/d; KV write.
  decode:  weights + whole KV/state read per token; activations negligible.

The weights count at 2 bytes an element, as the reference's bf16; the
port's dry run (``launch/dryrun.py``) reports it beside the bytes it
tracks on ``meta`` at the port's f32.  The optimizer's term reads the
gradient, m and v and writes m, v and the bf16 weights; the gradient's
read is ``grad_bytes_per_elem`` (the reference's f32 4 by default, 2 where
its ``grads_bf16`` policy accumulates microbatches in bf16).
"""
from __future__ import annotations

from repro_torch.lm.config import ArchConfig


def hbm_bytes_per_device(cfg: ArchConfig, kind: str, seq: int, batch: int,
                         chips: int, microbatches: int = 1,
                         kv_bytes_per_elem: float = 2.0,
                         grad_bytes_per_elem: float = 4.0) -> float:
    """Bytes one device moves in one step of ``kind`` (train, prefill,
    decode or long-decode) at ``seq`` x ``batch`` over ``chips``."""
    n_act = cfg.active_param_count()
    w_bf16 = 2.0 * n_act
    d, L = cfg.d_model, cfg.n_layers
    if kind == "train":
        tokens = batch * seq
        weights = 3.0 * w_bf16 * microbatches / chips
        opt = ((2.0 + grad_bytes_per_elem + 2 * 4.0 + 2 * 4.0)
               * cfg.param_count() / chips)
        acts = 12.0 * tokens * d * L / chips
        return weights + opt + acts
    if kind == "prefill":
        tokens = batch * seq
        weights = w_bf16 / chips
        acts = 6.0 * tokens * d * L / chips
        kv = (2.0 * L * batch * cfg.n_kv_heads * cfg.d_head * seq
              * kv_bytes_per_elem / chips
              if cfg.block_type == "transformer" else 0.0)
        return weights + acts + kv
    # decode / long-decode: one token per sequence
    weights = w_bf16 / chips
    kv = 0.0
    if cfg.block_type == "transformer" or cfg.attn_every:
        layers = (L if cfg.block_type == "transformer"
                  else L // max(1, cfg.attn_every))
        kv = (2.0 * layers * batch * cfg.n_kv_heads * cfg.d_head * seq
              * kv_bytes_per_elem) / chips
    if cfg.block_type in ("mamba2", "mlstm"):
        din = cfg.d_inner
        hp = din // max(1, cfg.ssm_heads)
        state = L * batch * cfg.ssm_heads * hp * max(cfg.ssm_state, hp) * 4
        kv += 2.0 * state / chips
    return weights + kv
