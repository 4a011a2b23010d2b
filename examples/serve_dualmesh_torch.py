"""Serve a small LM on the dual-core continuous-batching runtime of the
PyTorch/CUDA port through the shared streaming engine API: the paper's
interleaved schedule generalized to an N-stream request queue on one card,
the c-core and the p-core two disjoint sets of its SMs.

    PYTHONPATH=src python examples/serve_dualmesh_torch.py [--device cpu]

Counterpart of ``examples/serve_dualmesh.py``: the reference's 256-chip
plan (``n_devices=256``), ``split_mesh`` and ``TpuModel`` become the plan
on the card's SMs (``card_model``, priced by ``CardModel``),
``split_streams`` (green contexts on disjoint SMs) and the card's cost
model in the admission plan.
"""
import argparse

from repro_torch.configs.registry import get_smoke
from repro_torch.dualmesh import (DualMeshRunner, card_model, card_split,
                                  plan_admission, request_stages, search,
                                  split_streams)
from repro_torch.dualmesh.runtime import random_prompts
from repro_torch.kernels.util import resolve_device
from repro_torch.lm.model import load_params
from repro_torch.serving.api import Request
from repro_torch.serving.lm import DualMeshEngine

N_STREAMS = 4
BATCH, PROMPT, GEN = 4, 64, 32


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; needs a card) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)          # no card: fail before the work

    cfg = get_smoke("qwen2_5_14b")
    # 1. design flow: pick theta for the N-stream workload on the card's
    #    SMs (a modelled H100 on the CPU)
    hw = card_model(args.device)
    stages = request_stages(cfg, [(BATCH, PROMPT, GEN)])
    plan = search(stages, cfg, hw=hw, max_evals=8, n_streams=N_STREAMS)
    split = card_split(plan.theta, hw.sm_count)
    print(f"plan: theta={plan.theta:.4f} (c {split.c_sms}, p "
          f"{split.p_sms} of {hw.sm_count} SMs) {N_STREAMS}-stream "
          f"makespan={plan.makespan*1e3:.1f} ms")

    # 2. makespan-aware admission: how many prefilled streams to fuse
    #    per decode batch, each core priced at its share of the SMs
    dual = split_streams(args.device, plan.theta)
    adm = plan_admission(cfg, dual, hw, BATCH, PROMPT, GEN, N_STREAMS)
    print(f"admission: fuse decode groups of {adm.group_size} "
          f"(est {adm.est_tokens_per_s:.0f} tok/s model-side); "
          f"{dual.cores.describe()}")

    # 3. execute the request queue on the two cores, through the shared
    #    engine API (submit -> step -> drain)
    params = load_params(cfg, seed=0, device=dual.device)
    runner = DualMeshRunner(cfg, params, dual, max_len=PROMPT + GEN + 8)
    engine = DualMeshEngine(runner, group_size=adm.group_size)
    prompts = random_prompts(cfg, N_STREAMS, BATCH, PROMPT, seed=1,
                             device=dual.device)
    for p in prompts:
        engine.submit(Request(p, gen_steps=GEN))
    res = engine.drain()
    shapes = [tuple(o.shape) for o in res.outputs]
    print(f"generated {shapes} in {res.stats['wall_s']*1e3:.0f} ms "
          f"({res.stats['tokens_per_s']:.0f} tok/s, fused decode batches "
          f"{res.stats['fused_sizes']}, p95 request latency "
          f"{res.metrics.p95_ms():.0f} ms)")
    for kind, core, t in res.trace:
        print(f"  {kind:<8} on {core}-core  {t*1e3:7.1f} ms")


if __name__ == "__main__":
    main()
