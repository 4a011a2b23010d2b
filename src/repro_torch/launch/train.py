"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_0_5b \\
      --steps 8 --global-batch 8 --seq-len 512 [--ckpt-dir DIR] [--resume]

Port of ``repro/launch/train.py``: the fault-tolerant ``TrainRunner``
(checkpoints, recovery, straggler accounting) on any registered
architecture, with the reference's flags and ``--device`` (default
``cuda``: the card, which it needs; ``--device cpu`` runs the plain
versions on the CPU).  ``--smoke`` selects the reduced config, otherwise
the published one is used.  The checkpoints go under the system's
temporary directory unless ``--ckpt-dir`` says otherwise.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

from repro_torch.configs.registry import ARCH_IDS, get_arch, get_smoke
from repro_torch.data.pipeline import DataConfig
from repro_torch.train.optimizer import AdamW
from repro_torch.train.runner import RunnerConfig, TrainRunner


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; needs a card) or cpu")
    return ap.parse_args(argv)


def run(argv=None) -> TrainRunner:
    """Everything ``main`` does but the exit code: parse ``argv``, train,
    print the summary; returns the runner (its ``state`` the state after
    the last step, its ``saves`` and ``metrics_log`` what it recorded)."""
    args = parse(argv)
    cfg = get_smoke(args.arch) if args.smoke else get_arch(args.arch)
    rcfg = RunnerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                        max_steps=args.steps,
                        microbatches=args.microbatches)
    opt = AdamW(lr=args.lr, total_steps=args.steps,
                warmup_steps=max(1, args.steps // 10))
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                          global_batch=args.global_batch)
    runner = TrainRunner(cfg, rcfg, optimizer=opt, data_cfg=data_cfg,
                         device=args.device)
    if not args.resume:
        shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    out = runner.run()
    print(f"[train] arch={cfg.name} device={runner.device} "
          f"steps={out['final_step']} loss={out['final_loss']:.4f} "
          f"recoveries={out['recoveries']} stragglers={out['stragglers']}")
    for m in out["metrics"][:: max(1, len(out["metrics"]) // 10)]:
        print(f"  step {m['step']:>5}  loss {m['loss']:.4f}  "
              f"lr {m['lr']:.2e}  {m['step_time_s']*1e3:.0f} ms")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(out, f, indent=1)
    return runner


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
