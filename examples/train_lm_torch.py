"""End to end on the PyTorch/CUDA port: train a ~100M-param LM for a few
hundred steps with checkpoint/restart fault tolerance.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 300]
        [--device cpu]

Counterpart of ``examples/train_lm.py``, the same model and data on the
card (``--device cpu``: the plain PyTorch versions).
"""
import argparse
import os
import tempfile

from repro_torch.configs.registry import get_smoke
from repro_torch.data.pipeline import DataConfig
from repro_torch.kernels.util import resolve_device
from repro_torch.train.optimizer import AdamW
from repro_torch.train.runner import RunnerConfig, TrainRunner


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; needs a card) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)          # no card: fail before the work

    # ~100M params: xlstm smoke scaled up
    cfg = get_smoke("xlstm_350m").scaled(
        name="xlstm_100m", n_layers=12, d_model=768, n_heads=4,
        n_kv_heads=4, d_head=192, vocab=8192)
    print(f"model: {cfg.name}, {cfg.param_count()/1e6:.0f}M params")
    runner = TrainRunner(
        cfg,
        RunnerConfig(ckpt_dir=args.ckpt, ckpt_every=50,
                     max_steps=args.steps, microbatches=2),
        optimizer=AdamW(lr=1e-3, warmup_steps=20, total_steps=args.steps),
        data_cfg=DataConfig(vocab=cfg.vocab, seq_len=128, global_batch=8),
        device=args.device)
    out = runner.run()
    first = out["metrics"][0]["loss"]
    last = out["final_loss"]
    print(f"loss {first:.3f} -> {last:.3f} over {out['final_step']} steps "
          f"({out['recoveries']} recoveries, "
          f"{out['stragglers']} straggler steps) on {runner.device}")
    assert last < first, "loss must decrease"


if __name__ == "__main__":
    main()
