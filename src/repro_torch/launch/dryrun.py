"""One-card dry run: every (architecture x input shape) cell on ``meta``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2_0_5b \\
        --shape decode_32k [--out results/dryrun_torch]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2_0_5b \\
        --shape train_4k --grads-bf16

Counterpart of ``repro/launch/dryrun.py`` on one H100.  The reference
lowers and compiles each cell's step for a TPU pod and reads XLA's
memory and cost analyses; the port has no compiler to ask, so it runs the
cell's step eagerly on PyTorch's ``meta`` device, where every tensor has
a shape and a dtype but no memory and no values, and counts as it goes:

- the operations: the products' FLOPs under
  ``torch.utils.flop_counter.FlopCounterMode`` plus the kernels', which
  each wrapper's ``meta`` branch adds to a ``meta_ops`` counter (counted
  as ``chip_smoke.py``'s bounds count them: the (query, key) pairs a
  causal mask leaves, not the square);
- the bytes: :class:`LiveBytes` follows every storage the step allocates
  from its first to its last reference, parameters, optimizer state,
  activations that autograd saves, gradients and scratch alike, and keeps
  the peak.  That is what the card's ``torch.cuda.max_memory_allocated``
  reports for the same step, less the allocator's rounding and the
  libraries' workspaces (``chip_smoke.py`` holds the two within 10%).

A cell is the reference's: ``train`` runs ``make_train_step`` (AdamW,
``microbatches_for``'s microbatches, remat) on ``state_shapes``'s state;
``prefill`` one ``decode_step`` of the whole sequence into an empty cache
of its length; ``decode`` and ``long-decode`` one ``decode_step`` of one
token over a full cache (its last position free).  The port's tensors are
float32 (the reference's dry run is bf16), ``kv_dtype=torch.int8`` asks
for the int8 KV cache, and ``grad_dtype=torch.bfloat16`` (``--grads-bf16``,
the reference's ``grads_bf16`` policy) accumulates a train cell's
microbatch gradients in bf16.  No kernel is launched, no card is needed and
TF32 is not involved: ``meta`` computes nothing.

The result keeps the reference's keys that mean something on one card
(``mesh`` "h100", ``chips`` 1, ``t_collective_s`` 0) and its formulas:
``microbatches_for``, ``model_flops`` and ``hbm_bytes_per_device``
(``launch/roofline_model.py``, whose weights count 2 bytes an element as
the reference's, its KV cache at the port's 4, or 1 for int8, and the
optimizer's gradient read at 4, or 2 where bf16 accumulates);
``t_compute_s`` and ``t_memory_s`` put the counted operations and that
model's bytes at the H100 SXM's 67 TFLOP/s of f32 and 3.35 TB/s (the
data sheet, as ``chip_smoke.py``), and ``fits_hbm`` holds the tracked
peak against the card's 80 GB (``dualmesh/cost.py`` ``CardModel``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.registry import ARCH_IDS, SHAPES, cells, get_arch
from repro_torch.kernels.util import meta_ops
from repro_torch.launch.roofline_model import hbm_bytes_per_device
from repro_torch.lm.config import ArchConfig
from repro_torch.lm.model import decode_step, init_cache
from repro_torch.lm.steps import TrainState, make_train_step, state_shapes
from repro_torch.train.optimizer import AdamW

META = torch.device("meta")
HBM_BYTES = 80 * 10 ** 9                # CardModel.mem_bytes
PEAK_FLOPS = 67e12                      # f32 on the CUDA cores
HBM_BW = 3.35e12                        # bytes/s
VISION_PATCHES = 256                    # the reference's stub: patches a row


# --------------------------------------------------------------------------
# Shape-policy helpers (the reference's)
# --------------------------------------------------------------------------
def microbatches_for(cfg: ArchConfig, batch: int,
                     data_size: int = 16) -> int:
    """The reference's microbatch count for a train cell: more for wider
    models, at most ``batch // data_size`` and a divisor of ``batch``."""
    if cfg.d_model >= 8192:
        mb = 16
    elif cfg.d_model >= 4096:
        mb = 8
    elif cfg.d_model >= 2048:
        mb = 4
    else:
        mb = 2
    mb = min(mb, max(1, batch // data_size))   # keep b/mb shardable
    while batch % mb:
        mb //= 2
    return max(1, mb)


def model_flops(cfg: ArchConfig, kind: str, seq: int, batch: int) -> float:
    """The reference's analytic MODEL_FLOPS of a step of ``kind``: 6 N
    (train) or 2 N (prefill, decode) a token of the active parameters,
    plus attention over the whole S x S square (S a token in decode)."""
    n = cfg.active_param_count()
    if kind == "train":
        tokens = batch * seq
        base = 6.0 * n * tokens
        attn = 0.0
        if cfg.block_type == "transformer":
            attn = 12.0 * cfg.n_layers * batch * seq * seq * cfg.q_dim
        return base + attn
    if kind == "prefill":
        tokens = batch * seq
        base = 2.0 * n * tokens
        attn = 0.0
        if cfg.block_type == "transformer":
            attn = 4.0 * cfg.n_layers * batch * seq * seq * cfg.q_dim
        return base + attn
    # decode: one token per sequence + KV/state read
    base = 2.0 * n * batch
    attn = 0.0
    if cfg.block_type == "transformer":
        attn = 4.0 * cfg.n_layers * batch * seq * cfg.q_dim
    return base + attn


def input_specs(cfg: ArchConfig, shape_name: str):
    """``meta`` stand-ins for every model input of the cell, in the
    reference's shapes (token ids int64 and activations float32, the
    port's types): tokens, and labels to train; ``positions3`` for M-RoPE;
    Whisper's ``enc_input`` and Qwen2-VL's 256 ``extra_embeds`` a row to
    train.  Returns (inputs, kind, seq, batch)."""
    seq, batch, kind = SHAPES[shape_name]
    out = {}
    s_tok = seq if kind in ("train", "prefill") else 1
    out["tokens"] = torch.empty((batch, s_tok), dtype=torch.int64,
                                device=META)
    if kind == "train":
        out["labels"] = torch.empty((batch, seq), dtype=torch.int64,
                                    device=META)
    if cfg.mrope:
        out["positions3"] = torch.empty((batch, 3, s_tok),
                                        dtype=torch.int64, device=META)
    if cfg.encoder_decoder and kind == "train":
        out["enc_input"] = torch.empty((batch, cfg.enc_positions,
                                        cfg.d_model), device=META)
    if cfg.frontend == "vision" and kind == "train":
        out["extra_embeds"] = torch.empty((batch, VISION_PATCHES,
                                           cfg.d_model), device=META)
    return out, kind, seq, batch


def abstract_state(cfg: ArchConfig) -> TrainState:
    """The train state of ``cfg`` on ``meta``: ``lm/steps.py``
    ``state_shapes``'s parameters, and AdamW's moments as ``AdamW.init``
    makes them (m and v apart: ``state_shapes`` lets v share m's
    tensors, which a restore does not mind and a byte count does)."""
    params = state_shapes(cfg).params
    return TrainState(params, AdamW().init(params),
                      torch.zeros((), dtype=torch.int32, device=META))


def abstract_cache(cfg: ArchConfig, batch: int, max_len: int,
                   kv_dtype: torch.dtype | None = None, params=None):
    """An empty decode cache on ``meta`` (``init_cache``); Whisper's takes
    ``meta`` encoder memory and ``params`` (default ``abstract_state``'s)
    to project its cross K/V."""
    memory = None
    if cfg.encoder_decoder:
        params = params if params is not None else abstract_state(
            cfg).params
        memory = torch.empty((batch, cfg.enc_positions, cfg.d_model),
                             device=META)
    return init_cache(cfg, batch, max_len, device=META, memory=memory,
                      params=params, kv_dtype=kv_dtype)


# --------------------------------------------------------------------------
# live bytes
# --------------------------------------------------------------------------
class LiveBytes(TorchDispatchMode):
    """The bytes of every storage alive on ``device``, and their peak.

    Every tensor an operation returns is looked at: a storage not seen
    before is held by the tracker (so its identity, the C++ storage's
    address, cannot be reused while it is tracked) and its bytes are
    added.  A tracked storage whose only owner left is the tracker is
    dead, and :meth:`sweep` drops it and takes its bytes off: the
    storage's Python wrapper may die before the storage does, autograd
    keeps saved tensors alive from C++, and every ``meta`` storage's data
    pointer is 0, so neither a weak reference nor the address of the data
    can tell when a storage dies; its use count can.  Between sweeps
    ``current`` may still count dead storages, so it is never below the
    live bytes: a new storage that keeps it at or under the peak cannot
    raise the peak, and only one that would pass the peak sweeps first.
    :meth:`track` counts tensors made before the mode was entered."""

    def __init__(self, device: torch.device = META):
        super().__init__()
        self.device = torch.device(device)
        self._live: dict[int, tuple[torch.UntypedStorage, int]] = {}
        self.current = 0
        self.peak = 0

    def track(self, *trees) -> None:
        """Count the storages of every tensor in ``trees``."""
        for t in tree_leaves(trees):
            if isinstance(t, torch.Tensor):
                self._see(t)

    def sweep(self) -> None:
        """Drop every tracked storage the tracker alone holds."""
        dead = [key for key in self._live
                if torch._C._storage_Use_Count(key) == 1]
        for key in dead:
            self.current -= self._live.pop(key)[1]

    def _see(self, t: torch.Tensor) -> None:
        if t.device != self.device:
            return
        st = t.untyped_storage()
        key, nbytes = st._cdata, st.nbytes()
        seen = self._live.get(key)
        grow = nbytes - (0 if seen is None else seen[1])   # new or resized
        if seen is not None and grow == 0:
            return
        if self.current + grow > self.peak:
            self.sweep()
        self._live[key] = (st, nbytes)
        self.current += grow
        self.peak = max(self.peak, self.current)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._see(t)
        return out


# --------------------------------------------------------------------------
# one step on meta
# --------------------------------------------------------------------------
def dry_step(cfg: ArchConfig, kind: str, seq: int, batch: int,
             inputs: dict | None = None, microbatches: int = 1,
             kv_dtype: torch.dtype | None = None,
             max_len: int | None = None,
             grad_dtype: torch.dtype | None = None) -> dict:
    """Run one step of ``kind`` at ``seq`` x ``batch`` on ``meta``: its
    counted operations (``flops``: the products'; ``kernel_ops``: the
    kernels', by wrapper) and the peak of its live bytes (``peak_bytes``,
    the state, cache and inputs included).  ``inputs`` default to
    stand-ins of :func:`input_specs`'s shapes (tokens, and labels to
    train); the cache holds ``max_len`` positions (default ``seq``);
    ``grad_dtype`` is ``make_train_step``'s.  ``base_bytes`` are the
    state's, cache's and inputs' bytes before the step."""
    if inputs is None:
        s_tok = seq if kind in ("train", "prefill") else 1
        inputs = {"tokens": torch.empty((batch, s_tok), dtype=torch.int64,
                                        device=META)}
        if kind == "train":
            inputs["labels"] = inputs["tokens"]
    live = LiveBytes()
    flops = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    if kind == "train":
        state = abstract_state(cfg)
        step = make_train_step(cfg, AdamW(), microbatches=microbatches,
                               grad_dtype=grad_dtype)
        live.track(state, inputs)
        base = live.current
        with meta_ops() as ops, flops, live:
            step(state, inputs)
    else:
        params = abstract_state(cfg).params
        cache = abstract_cache(cfg, batch, max_len or seq, kv_dtype, params)
        if kind != "prefill":                   # filled to seq, one free
            cache = cache._replace(pos=seq - 1)
        live.track(params, cache, inputs)
        base = live.current
        with torch.no_grad(), meta_ops() as ops, flops, live:
            decode_step(params, cfg, inputs["tokens"], cache,
                        positions3=inputs.get("positions3"))
    return dict(flops=int(flops.get_total_flops()),
                kernel_ops=dict(ops.by_kernel), peak_bytes=live.peak,
                base_bytes=base, run_s=time.perf_counter() - t0)


def run_cell(arch: str, shape_name: str, verbose: bool = True,
             microbatches: int | None = None,
             kv_dtype: torch.dtype | None = None,
             grad_dtype: torch.dtype | None = None) -> dict:
    """The dry run of cell (``arch``, ``shape_name``) on one card.
    ``microbatches`` (train; default ``microbatches_for(cfg, batch, 16)``),
    ``kv_dtype`` (the cache's; default float32) and ``grad_dtype`` (the
    microbatch gradients' sum; default float32, ``torch.bfloat16`` for
    the reference's ``grads_bf16`` policy) are the reference's knobs."""
    cfg = get_arch(arch)
    inputs, kind, seq, batch = input_specs(cfg, shape_name)
    mb = (microbatches or microbatches_for(cfg, batch, 16)
          if kind == "train" else 1)
    got = dry_step(cfg, kind, seq, batch, inputs, mb, kv_dtype,
                   grad_dtype=grad_dtype)
    counted = got["flops"] + sum(got["kernel_ops"].values())
    mf = model_flops(cfg, kind, seq, batch)
    kv_bytes = 1.0 if kv_dtype == torch.int8 else 4.0
    grad_dtype = grad_dtype if kind == "train" and mb > 1 else None
    grad_bytes = (grad_dtype or torch.float32).itemsize
    hbm = hbm_bytes_per_device(cfg, kind, seq, batch, 1, mb, kv_bytes,
                               grad_bytes)
    result = {
        "arch": arch, "shape": shape_name, "kind": kind, "mesh": "h100",
        "chips": 1, "seq": seq, "batch": batch, "microbatches": mb,
        "kv_dtype": str(kv_dtype or torch.float32).replace("torch.", ""),
        "grad_dtype": str(grad_dtype or torch.float32).replace("torch.",
                                                               ""),
        "run_s": got["run_s"],
        "flops_per_device": counted,
        "matmul_flops": got["flops"],
        "kernel_ops": got["kernel_ops"],
        "model_flops": mf,
        "useful_flops_ratio": mf / counted if counted else None,
        "hbm_bytes_per_device": hbm,
        "per_device_bytes": got["peak_bytes"],
        "fits_hbm": got["peak_bytes"] < HBM_BYTES,
        "t_compute_s": counted / PEAK_FLOPS,
        "t_memory_s": hbm / HBM_BW,
        "t_collective_s": 0.0,
        "ok": True,
    }
    if verbose:
        dom = max(("t_compute_s", "t_memory_s"), key=lambda k: result[k])
        print(f"[dryrun] {arch} {shape_name} h100 run={got['run_s']:.1f}s "
              f"flops={counted:.3e} model={mf:.3e} "
              f"hbm_model={hbm:.3e} dominant={dom} "
              f"peak_bytes={got['peak_bytes']} fits={result['fits_hbm']}")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--grads-bf16", action="store_true",
                    help="accumulate a train cell's microbatch gradients "
                    "in bf16 (the reference's grads_bf16 policy)")
    args = ap.parse_args(argv)
    grad_dtype = torch.bfloat16 if args.grads_bf16 else None
    if args.all:
        todo = cells()
    elif args.arch and args.shape:
        todo = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, or --all")
    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch, shape in todo:
        tag = f"{arch}.{shape}.h100"
        try:
            res = run_cell(arch, shape, grad_dtype=grad_dtype)
        except Exception as e:  # noqa: BLE001 - record and continue
            failures += 1
            res = {"arch": arch, "shape": shape, "mesh": "h100", "ok": False,
                   "error": f"{type(e).__name__}: {e}"}
            print(f"[dryrun] FAIL {tag}: {res['error']}", file=sys.stderr)
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(res, f, indent=1)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
