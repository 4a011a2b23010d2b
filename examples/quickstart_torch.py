"""Quickstart on the PyTorch/CUDA port: the paper's dual-OPU design flow
end to end on MobileNet v1, then the same model on the card.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
        [--image-size 224]

Counterpart of ``examples/quickstart.py``: the modelled FPGA numbers are
the same; the forward runs the hand-written CUDA kernels on the card
(``--device cpu``: their plain PyTorch versions).
"""
import argparse

import numpy as np
import torch

from repro_torch.core.arch import DUAL_MBV1, P128_9, BoardModel
from repro_torch.core.area import dual_core_area
from repro_torch.core.scheduler import best_schedule
from repro_torch.core.simulator import (simulate_dual_core,
                                        simulate_single_core)
from repro_torch.kernels.util import resolve_device
from repro_torch.models.cnn import build_model
from repro_torch.models.zoo import get_graph


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; needs a card) or cpu")
    ap.add_argument("--image-size", type=int, default=224)
    args = ap.parse_args(argv)
    resolve_device(args.device)          # no card: fail before the work

    board = BoardModel()
    g = get_graph("mobilenet_v1")
    print(g.summary()[:600], "...\n")

    # 1. single-core baseline (paper Table IV / VI baseline)
    sim = simulate_single_core(g, P128_9, board)
    print(f"P(128,9) baseline: {sim.cycles:,} cycles "
          f"-> {board.fps(sim.cycles):.1f} fps "
          f"(paper board: 755,857 cycles / 264.6 fps)")

    # 2. heterogeneous dual-core with the paper's best MobileNet v1 config
    sched = best_schedule(g, DUAL_MBV1, board)
    dual = simulate_dual_core(sched)
    area = dual_core_area(DUAL_MBV1)
    print(f"{DUAL_MBV1}: {dual.fps:.1f} fps "
          f"(+{dual.fps/board.fps(sim.cycles)-1:.0%} vs baseline; "
          f"paper: 358.4 fps) at {area.dsp} DSP, "
          f"PE eff {dual.pe_efficiency:.0%}")

    # 3. the same model in PyTorch (the CUDA kernels on the card)
    params, fwd, _ = build_model("mobilenet_v1", device=args.device)
    dev = next(iter(params.values()))["w"].device
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, args.image_size, args.image_size, 3)).astype(np.float32)).to(dev)
    logits = fwd(params, x)
    print(f"PyTorch forward on {dev}: logits {tuple(logits.shape)}, "
          f"finite={bool(torch.isfinite(logits).all())}")


if __name__ == "__main__":
    main()
