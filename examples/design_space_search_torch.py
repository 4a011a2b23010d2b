"""The paper's §V-B co-optimization on the PyTorch/CUDA port: find the best
dual-core PE allocation for a multi-CNN workload, then *execute* the
winning schedule on the pipelined dual-core runtime (search -> schedule ->
measured img/s), plus the LM-side twin (the c/p split of the card's SMs).

    PYTHONPATH=src python examples/design_space_search_torch.py
        [--device cpu] [--smoke]

Counterpart of ``examples/design_space_search.py``.  The TPU side's
256-chip pod (``n_devices=256``, ``split_mesh``) becomes the card's SMs
(``card_model``, priced by ``CardModel``, split by ``card_split``), and the
same pod of abstract cards (``abstract_split``) for comparison.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.core.arch import BoardModel
from repro_torch.core.search import search as fpga_search
from repro_torch.dualcore.runtime import DualCoreRunner
from repro_torch.dualmesh import (abstract_split, card_model, card_split,
                                  request_stages, search as card_search)
from repro_torch.kernels.util import resolve_device
from repro_torch.models.cnn import build_model
from repro_torch.models.zoo import get_graph
from repro_torch.serving.cnn import stream_images


def measured_fps(model: str, schedule, device: str, image_size: int,
                 images: int = 4) -> float:
    """Run the found schedule for real on the two cores (the card's SM
    split, or the CPU) and report measured streaming throughput through
    the serving engine."""
    params, _, _ = build_model(model, device=device)
    runner = DualCoreRunner(model, params, schedule, device=device)
    rng = np.random.default_rng(1)
    xs = [torch.from_numpy(rng.standard_normal(
        (1, image_size, image_size, 3)).astype(np.float32)).to(
            runner.device) for _ in range(images)]
    runner.run_sequential(xs[:1])              # warm: build, capture
    return max(stream_images(runner, xs).stats["fps"] for _ in range(2))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; needs a card) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="minutes less of host: MobileNet v1 alone, one "
                         "evaluation of each search, no load balance, "
                         "32 px")
    args = ap.parse_args(argv)
    resolve_device(args.device)          # no card: fail before the work
    models = (("mobilenet_v1",) if args.smoke else
              ("mobilenet_v1", "mobilenet_v2", "squeezenet"))
    evals, image_size = (1, 32) if args.smoke else (None, 64)

    # FPGA side (the paper, Table VII)
    graphs = [get_graph(m) for m in models]
    res = fpga_search(graphs, BoardModel(), max_evals=evals or 6,
                      with_load_balance=not args.smoke)
    print(f"[fpga] best config {res.config} (theta={res.theta:.2f}), "
          f"harmonic fps={res.objective:.1f}")
    for m, fps in res.fps.items():
        meas = measured_fps(m, res.schedules[m], args.device, image_size)
        print(f"    {m:<14} {fps:7.1f} fps simulated   "
              f"{meas:7.1f} img/s measured ({image_size}px, "
              f"{args.device})")

    # the card side: the same flow, the c/p split of the card's SMs for
    # LM serving (a modelled H100 on the CPU)
    cfg = get_arch("qwen2_5_14b")
    stages = request_stages(cfg, [(8, 8192, 256)] * 4)
    hw = card_model(args.device)
    plan = card_search(stages, cfg, hw=hw, max_evals=evals or 10)
    split = card_split(plan.theta, hw.sm_count)
    print(f"[card] theta={plan.theta:.4f} (c {split.c_sms}, p {split.p_sms}"
          f" of {hw.sm_count} SMs) makespan={plan.makespan*1e3:.1f} ms, "
          f"{plan.tokens_per_s:.0f} tok/s")
    pod = card_search(stages, cfg, n_devices=256, hw=hw,
                      max_evals=evals or 10)
    chips = abstract_split(256, pod.theta, pod.tp_c, pod.tp_p)
    print(f"[pod]  theta={pod.theta:.2f} tp=({pod.tp_c},{pod.tp_p}) on 256 "
          f"abstract cards (c {chips.c_chips}, p {chips.p_chips}) "
          f"makespan={pod.makespan*1e3:.1f} ms, {pod.tokens_per_s:.0f} "
          f"tok/s")


if __name__ == "__main__":
    main()
