"""GQA attention: flash for prefill and decode for one new token (K7).

Wrappers of the hand-written CUDA kernels in ``csrc/flash_attention.cu``,
which replace the TPU kernels ``repro/kernels/attention/kernel.py::
flash_attention`` and ``::decode_attention`` (whose ragged ``kv_len`` case
the reference leaves to jnp); the source says what bounds each on an H100
and how the key loop inside a block stands in for the TPU's sequential k
grid axis.

Flash is one launch a call: a warp a 16-row slice of a q tile, both
products on the tensor cores in 3xTF32 with S, O and the softmax in
registers, K and V tiles staged by a cp.async ring; ``plan.py``'s
``plan_flash`` chooses the rows a block, the ring's depth and whether two
warp groups split a q tile's keys, from the shape.  Its limit: D from 1 to 128.

Decode is one launch a call: a thread-block cluster of up to 16 blocks a
(batch row, kv head) splits the keys in 32-key tiles staged by cp.async,
and the ranks merge their softmaxes in rank order through distributed
shared memory, so no scratch is allocated and the bits do not depend on
the stream.  GQA groups above 8 run their two products on the tensor
cores in 3xTF32, smaller ones on the CUDA cores; ``plan.py``'s
``plan_decode`` chooses that, the cluster and the slots from the shape.
Its limits: G <= 48, D up to 128: a power of two from 4 (8 where G > 8),
or a multiple of 8 (Zamba2's 80).

Flash is differentiable.  Where autograd records (grad mode on and q, k
or v requiring grad) ``flash_attention`` goes through
``_FlashAttention``, a ``torch.autograd.Function`` over its whole
signature (``causal``, ``q_offset``, ``sk_valid``, GQA): its forward asks
the kernel for each row's log-sum-exp as well (a pointer the kernel
writes only when given; serving passes none, and the output's bits are
the same either way), and its backward is ``flash_attention_bwd``, the
port's own kernels in ``csrc/flash_attention_bwd.cu`` (the reference
trains through XLA's attention, so no TPU kernel is replaced): a dQ
pass per (batch, query head, query tile) that also writes each row's D =
rowsum(dO O) and log-sum-exp to a scratch, then a dK/dV pass per (batch,
KV head, key tile) whose thread-block cluster may split the GQA group's
heads, both on the tensor cores in 3xTF32 with cp.async rings, no
atomics; ``plan.py``'s ``plan_flash_bwd`` chooses each pass's warps and
ring and the dK/dV pass's pairing of key tiles and cluster.  Decode has no
backward (no training path sends it one-row queries) and raises where
autograd records an input that requires grad.

Over an int8 KV cache (``init_cache(kv_dtype=torch.int8)``) attention
goes to ``flash_attention_int8`` (a block of query rows, causal at
``q_offset``) and ``decode_attention_int8`` (one row a query head, with
``kv_len``), the port's own kernels in ``csrc/flash_attention_int8.cu``
(the reference's int8 attention is jnp, so no TPU kernel is replaced):
the reference's arithmetic with int8 x int8 -> s32 dots, in two passes
over the keys, since the reference rounds the normalised probabilities;
``plan.py``'s ``plan_flash_int8`` and ``plan_decode_int8`` pick the rows a
block and the decode's cluster.  Their limits: D a multiple of 16 from 16
to 128, any G; q and out f32, k and v int8 16-byte aligned.  They have no
backward and raise where autograd records an input that requires grad.

k and v may be the first Sk rows of a longer cache (a view cut along the
sequence axis): the kernels read the cache in place.  q must be
contiguous.  A CUDA tensor launches the kernel on the current stream (or
raises); a CPU tensor runs the plain version from ``ref.py``; a ``meta``
tensor (the dry run, ``launch/dryrun.py``) launches nothing and computes
nothing: the wrapper allocates the outputs and scratch its CUDA branch
allocates and adds the call's operations, counted as ``chip_smoke.py``'s
bounds count them, to the open ``meta_ops`` counters.
``flash_attention.launches``, ``flash_attention_bwd.launches`` (a call:
one launch of its entry, the dQ and the dK/dV kernels),
``decode_attention.launches``, ``flash_attention_int8.launches`` and
``decode_attention_int8.launches`` count the launches.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.attention.plan import (plan_decode,
                                                plan_decode_int8, plan_flash,
                                                plan_flash_bwd,
                                                plan_flash_int8)
from repro_torch.kernels.attention.ref import (decode_attention_int8_ref,
                                               decode_attention_ref,
                                               flash_attention_bwd_ref,
                                               flash_attention_int8_ref,
                                               flash_attention_ref,
                                               visible_pairs)
from repro_torch.kernels.util import (add_meta_ops, check_cuda_operands,
                                      counted, launch)


def _shapes(name: str, q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor) -> tuple[int, int, int, int, int, int]:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or k.shape[1] < 1 or q.shape[1] % k.shape[1]:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    b, hq, sq, d = q.shape
    return b, hq, k.shape[1], sq, k.shape[2], d


def _kv_capacity(name: str, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, dtype: torch.dtype = torch.float32) -> int:
    """Rows per (batch, kv head) of the cache k and v are cut from; raises
    unless both are ``dtype`` on q's device with rows of D contiguous
    elements and heads and batches evenly strided (a contiguous tensor, or
    one cut along the sequence axis)."""
    b, hkv, sk, d = k.shape
    for key, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != dtype:
            raise TypeError(f"{name}: {key} is {t.dtype} on {t.device}, "
                            f"expected {dtype} on {q.device}")
        st = t.stride()
        if (st[3] != 1 or (sk > 1 and st[2] != d) or st[1] % d
                or st[1] // d < sk or (b > 1 and st[0] != hkv * st[1])):
            raise ValueError(f"{name}: {key} strides {st} are not a "
                             f"(possibly cut) contiguous cache")
    if k.stride() != v.stride():
        raise ValueError(f"{name}: k strides {k.stride()} != v strides "
                         f"{v.stride()}")
    return k.stride(1) // d


def _records(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _flash_forward(q, k, v, causal, q_offset, sk_valid, with_lse: bool):
    """The forward: out, or (out, lse (B, Hq, Sq)) with ``with_lse``."""
    b, hq, hkv, sq, sk, d = _shapes("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                                   sk_valid=sk_valid, with_lse=with_lse)
    if q.device.type == "meta":
        add_meta_ops("flash_attention", 4 * d * b * hq * visible_pairs(
            sq, sk, causal, q_offset, sk_valid))
        out = torch.empty_like(q)
        if not with_lse:
            return out
        return out, torch.empty((b, hq, sq), device=q.device)
    check_cuda_operands("flash_attention", q.device, q=q)
    plan = plan_flash(b, hq, hkv, sq, sk, d, bool(causal), int(q_offset),
                      None if sk_valid is None else int(sk_valid))
    kv_cap = _kv_capacity("flash_attention", q, k, v)
    out = torch.empty_like(q)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    vec = int(k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0)
    launch("repro_flash_attention", q.device, q, k, v, out, lse, b, hq, hkv,
           sq, sk, d, kv_cap, int(causal), int(q_offset),
           sk if sk_valid is None else int(sk_valid), 1.0 / math.sqrt(d),
           plan.warps, plan.ring, plan.kv_split, plan.smem_bytes, vec)
    flash_attention.launches += 1
    return (out, lse) if with_lse else out


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, sk_valid):
        out, lse = _flash_forward(q, k, v, causal, q_offset, sk_valid, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, q_offset, sk_valid)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, q_offset, sk_valid = ctx.mask
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, dout.contiguous(), lse, causal=causal,
            q_offset=q_offset, sk_valid=sk_valid)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0,
                    sk_valid: int | None = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D); Hq % Hkv == 0 (GQA).

    Query row i sits at key position ``q_offset + i``; keys at or past
    ``sk_valid`` (default Sk) are masked.  Returns (B, Hq, Sq, D)."""
    _shapes("flash_attention", q, k, v)
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset {q_offset} < 0")
    if _records(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, q_offset, sk_valid)
    return _flash_forward(q, k, v, causal, q_offset, sk_valid, False)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor,
                        lse: torch.Tensor, *, causal: bool = True,
                        q_offset: int = 0, sk_valid: int | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients (dq, dk, dv) of ``flash_attention(q, k, v, ...)``
    given its output ``out``, the output's gradient ``dout`` and the rows'
    log-sum-exp ``lse`` (B, Hq, Sq) its forward wrote.  dk and dv are
    contiguous (B, Hkv, Sk, D), zero at keys no row sees."""
    b, hq, hkv, sq, sk, d = _shapes("flash_attention_bwd", q, k, v)
    if out.shape != q.shape or dout.shape != q.shape \
            or lse.shape != (b, hq, sq):
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)}, "
                         f"dout {tuple(dout.shape)}, lse {tuple(lse.shape)} "
                         f"for q {tuple(q.shape)}")
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, dout, lse,
                                       causal=causal, q_offset=q_offset,
                                       sk_valid=sk_valid)
    if q.device.type == "meta":
        add_meta_ops("flash_attention_bwd", 10 * d * b * hq * visible_pairs(
            sq, sk, causal, q_offset, sk_valid))
        dq = torch.empty_like(q)
        dk = torch.empty((b, hkv, sk, d), device=q.device)
        dv = torch.empty_like(dk)
        torch.empty((2, b, hq, sq), device=q.device)      # the scratch
        return dq, dk, dv
    check_cuda_operands("flash_attention_bwd", q.device, q=q, out=out,
                        dout=dout, lse=lse)
    if d > 128:
        raise ValueError(f"flash_attention_bwd: D {d} > 128")
    kv_cap = _kv_capacity("flash_attention_bwd", q, k, v)
    plan = plan_flash_bwd(b, hq, hkv, sq, sk, d, bool(causal), int(q_offset),
                          None if sk_valid is None else int(sk_valid))
    dq = torch.empty_like(q)
    dk = torch.empty((b, hkv, sk, d), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    rows = torch.empty((2, b, hq, sq), dtype=torch.float32, device=q.device)
    launch("repro_flash_attention_bwd", q.device, q, k, v, out, dout, lse,
           dq, dk, dv, rows, b, hq, hkv, sq, sk, d, kv_cap, int(causal),
           int(q_offset), sk if sk_valid is None else int(sk_valid),
           1.0 / math.sqrt(d), plan.q_warps, plan.q_ring, plan.kv_warps,
           plan.kv_ring, int(plan.pair), plan.cluster, plan.q_smem_bytes,
           plan.kv_smem_bytes)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor | None = None) -> torch.Tensor:
    """Single-token decode: q (B, Hq, 1, D) against k/v (B, Hkv, S, D).

    ``kv_len`` (B,) int32, optional, masks each row's cache to its first
    ``kv_len[b]`` positions (ragged decode)."""
    b, hq, hkv, sq, sk, d = _shapes("decode_attention", q, k, v)
    if _records(q, k, v):
        raise RuntimeError("decode_attention has no backward: an input "
                           "requires grad while autograd records")
    if sq != 1:
        raise ValueError(f"decode_attention: Sq {sq} != 1")
    if kv_len is not None and tuple(kv_len.shape) != (b,):
        raise ValueError(f"decode_attention: kv_len {tuple(kv_len.shape)}, "
                         f"expected ({b},)")
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, kv_len)
    if q.device.type == "meta":
        add_meta_ops("decode_attention", 4 * hq * d * b * sk)
        return torch.empty_like(q)
    check_cuda_operands("decode_attention", q.device, q=q)
    plan = plan_decode(b, hq, hkv, sk, d)
    if kv_len is not None and (kv_len.device != q.device
                               or kv_len.dtype != torch.int32
                               or not kv_len.is_contiguous()):
        raise TypeError(f"decode_attention: kv_len must be contiguous int32 "
                        f"on {q.device}")
    kv_cap = _kv_capacity("decode_attention", q, k, v)
    out = torch.empty_like(q)
    vec = int(k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0)
    launch("repro_decode_attention", q.device, q, k, v, kv_len, out, b, hq,
           hkv, sk, d, kv_cap, int(plan.tc), plan.cluster, plan.slots,
           plan.smem_bytes, vec, 1.0 / math.sqrt(d))
    decode_attention.launches += 1
    return out


def _int8_operands(name: str, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> int:
    """The int8 kernels' checks on the card; returns the cache's rows per
    (batch, kv head)."""
    check_cuda_operands(name, q.device, q=q)
    kv_cap = _kv_capacity(name, q, k, v, torch.int8)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name}: q, k and v must be 16-byte aligned")
    return kv_cap


def _int8_checks(name: str, q, k, v) -> tuple[int, int, int, int, int, int]:
    shape = _shapes(name, q, k, v)
    if _records(q):
        raise RuntimeError(f"{name} has no backward: q requires grad while "
                           f"autograd records")
    return shape


def flash_attention_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, q_offset: int = 0,
                         sk_valid: int | None = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D) float32 against an int8 cache k, v (B, Hkv, Sk,
    D), Hq % Hkv == 0, with the reference's static scales
    (``ref.int8_attention_ref``).  Query row i sits at key position
    ``q_offset + i``; keys at or past ``sk_valid`` (default Sk) are
    masked; a row that sees no key is 0.  Returns (B, Hq, Sq, D) f32."""
    b, hq, hkv, sq, sk, d = _int8_checks("flash_attention_int8", q, k, v)
    if q_offset < 0:
        raise ValueError(f"flash_attention_int8: q_offset {q_offset} < 0")
    if q.device.type == "cpu":
        return flash_attention_int8_ref(q, k, v, causal=causal,
                                        q_offset=q_offset, sk_valid=sk_valid)
    plan = plan_flash_int8(b, hq, hkv, sq, sk, d)
    if q.device.type == "meta":
        add_meta_ops("flash_attention_int8", 4 * d * b * hq * visible_pairs(
            sq, sk, causal, q_offset, sk_valid))
        return torch.empty_like(q)
    kv_cap = _int8_operands("flash_attention_int8", q, k, v)
    out = torch.empty_like(q)
    launch("repro_flash_attention_int8", q.device, q, k, v, out, b, hq, hkv,
           sq, sk, d, kv_cap, int(causal), int(q_offset),
           sk if sk_valid is None else int(sk_valid), math.sqrt(d),
           plan.rows, plan.smem_bytes)
    flash_attention_int8.launches += 1
    return out


def decode_attention_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_len: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """Single-token decode over an int8 cache: q (B, Hq, 1, D) float32
    against k/v (B, Hkv, S, D) int8, the reference's static scales.
    ``kv_len`` (B,) int32, optional, masks each row's cache to its first
    ``kv_len[b]`` positions; a row with ``kv_len`` 0 is 0."""
    b, hq, hkv, sq, sk, d = _int8_checks("decode_attention_int8", q, k, v)
    if sq != 1:
        raise ValueError(f"decode_attention_int8: Sq {sq} != 1")
    if kv_len is not None and tuple(kv_len.shape) != (b,):
        raise ValueError(f"decode_attention_int8: kv_len "
                         f"{tuple(kv_len.shape)}, expected ({b},)")
    if q.device.type == "cpu":
        return decode_attention_int8_ref(q, k, v, kv_len)
    plan = plan_decode_int8(b, hq, hkv, sk, d)
    if q.device.type == "meta":
        add_meta_ops("decode_attention_int8", 4 * hq * d * b * sk)
        return torch.empty_like(q)
    kv_cap = _int8_operands("decode_attention_int8", q, k, v)
    if kv_len is not None and (kv_len.device != q.device
                               or kv_len.dtype != torch.int32
                               or not kv_len.is_contiguous()):
        raise TypeError(f"decode_attention_int8: kv_len must be contiguous "
                        f"int32 on {q.device}")
    out = torch.empty_like(q)
    launch("repro_decode_attention_int8", q.device, q, k, v, kv_len, out, b,
           hq, hkv, sk, d, kv_cap, math.sqrt(d), plan.rows, plan.cluster,
           plan.smem_bytes)
    decode_attention_int8.launches += 1
    return out


counted(flash_attention)
counted(flash_attention_bwd)
counted(decode_attention)
counted(flash_attention_int8)
counted(decode_attention_int8)
