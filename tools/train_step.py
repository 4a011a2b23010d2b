"""Where a training step's time goes on the card.

  PYTHONPATH=src python tools/train_step.py [--arch qwen2_0_5b] \\
      [--batch 8] [--seq-len 512] [--trace TRACE.json]

Builds the seed-0 train state at full width and depth on the card (as
``python -m repro_torch.launch.train`` does) and the data pipeline's
step-0 batch, runs one step to warm up, then:

1. times the stages of one step with CUDA events on the stream: the
   forward (logits), the loss, the backward (with remat: each layer's
   forward again), the optimizer (AdamW over the whole state);
2. profiles one whole step under ``torch.profiler`` and sums the
   kernels' device time by kind: the products (cuBLAS), K6 forward and
   backward, K7 flash forward and backward, and the rest (the loss's and
   the optimizer's elementwise passes and reductions, the embedding's
   backward, copies), beside the step's wall (the device's busy share;
   the profiler slows the host it measures);
3. times one checkpoint save of the state (host seconds, bytes), into a
   temporary directory under ``build/`` that it removes.

Writes the numbers to ``chiprun_out/train_step.json``.  A diagnostic for
the card only: nothing in the package calls it.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import sys
import tempfile
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels.util import resolve_device  # noqa: E402
from repro_torch.lm.model import forward  # noqa: E402
from repro_torch.lm.steps import (batch_to, logits_loss,  # noqa: E402
                                  make_init_state, make_train_step)
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.optimizer import AdamW  # noqa: E402
from repro_torch.train.tree import leaves, tree_map, unflatten  # noqa: E402

#: kernel kinds by a piece of the kernel's name, first match wins: K6's
#: backward is its rows pass (``rmsnorm_bwd_vec_kernel`` a warp a row, or
#: ``rmsnorm_bwd_rows_kernel``) and its dw pass (``rmsnorm_dw_kernel``);
#: K7 flash's backward its dQ and dK/dV passes (``flash_bwd_q_kernel``,
#: ``flash_bwd_kv_kernel``)
KINDS = (("K6 backward", ("rmsnorm_bwd", "rmsnorm_dw")),
         ("K6 forward", ("rmsnorm",)),
         ("K7 flash backward", ("flash_bwd",)),
         ("K7 flash forward", ("flash_attention_kernel",)),
         ("products", ("gemm", "Kernel2", "cutlass", "xmma")))


def kind(name: str) -> str:
    for k, keys in KINDS:
        if any(key in name for key in keys):
            return k
    return "other"


def stages(state, cfg, batch, opt) -> dict[str, float]:
    """Device ms of each stage of one step (CUDA events on the stream)."""
    params = state.params
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    live = [p.detach().requires_grad_() for p in leaves(params)]
    ev[0].record()
    logits = forward(unflatten(params, live), cfg, batch["tokens"],
                     remat=True)
    ev[1].record()
    loss = logits_loss(logits, cfg, batch)
    ev[2].record()
    grads = torch.autograd.grad(loss, live)
    ev[3].record()
    opt.apply(unflatten(tree_map(lambda p: p, params), grads), state.opt,
              params)
    ev[4].record()
    torch.cuda.synchronize()
    names = ("forward", "loss", "backward", "optimizer")
    return {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2_0_5b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--trace", default=None, metavar="TRACE.json")
    args = ap.parse_args(argv)

    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch(args.arch)
    opt = AdamW(total_steps=8, warmup_steps=1)
    state = make_init_state(cfg, opt, dev)(0)
    batch = batch_to(SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq_len,
        global_batch=args.batch)).batch_at(0), dev)
    step = make_train_step(cfg, opt)
    state, _ = step(state, batch)                   # warm-up
    torch.cuda.synchronize()

    st = stages(state, cfg, batch, opt)
    t0 = time.perf_counter()
    state, m = step(state, batch)
    float(m["loss"])
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        float(m["loss"])
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    by_kind: dict[str, float] = {}
    by_name: dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        ms = e.self_device_time_total / 1e3
        by_kind[kind(e.key)] = by_kind.get(kind(e.key), 0.0) + ms
        by_name[e.key] = by_name.get(e.key, 0.0) + ms
    busy = sum(by_kind.values())
    stray = [n for n in by_name if kind(n) == "other"
             and any(key in n for key in ("rmsnorm", "flash", "fb::"))]
    if stray:
        raise SystemExit(f"train_step: port kernels left unattributed: "
                         f"{stray}")
    tokens = args.batch * args.seq_len
    print(f"[train_step] {torch.cuda.get_device_name(0)}; {cfg.name}, "
          f"{args.batch} x {args.seq_len} tokens, remat: a step {wall_ms:.1f} "
          f"ms of wall ({tokens / wall_ms * 1e3:.0f} tokens/s)")
    print("[train_step] stages (CUDA events, device ms): "
          + ", ".join(f"{k} {v:.2f}" for k, v in st.items())
          + f"; sum {sum(st.values()):.2f}")
    print(f"[train_step] kernels by kind under the profiler (device ms, "
          f"step wall {prof_wall_ms:.1f} ms, busy {busy:.1f} ms = "
          f"{busy / prof_wall_ms:.3f}): "
          + ", ".join(f"{k} {v:.2f}" for k, v in sorted(
              by_kind.items(), key=lambda kv: -kv[1])))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:14]
    for name, ms in top:
        print(f"[train_step]   {kind(name):<17} {ms:8.3f} ms  {name[:90]}")
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="train_step_", dir=ROOT / "build")
    try:
        t0 = time.perf_counter()
        ckpt.save(tmp, state, 1)
        save_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    nbytes = sum(t.numel() * t.element_size() for t in leaves(state))
    print(f"[train_step] a checkpoint save: {nbytes / 1e9:.3f} GB in "
          f"{save_s:.2f} s of host")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "train_step.json").write_text(json.dumps(dict(
        device=torch.cuda.get_device_name(0), arch=cfg.name,
        batch=args.batch, seq_len=args.seq_len, wall_ms=wall_ms,
        stages_ms=st, profiled_wall_ms=prof_wall_ms, kinds_ms=by_kind,
        top_kernels_ms=dict(top), save_s=save_s, save_bytes=nbytes), indent=1))
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
