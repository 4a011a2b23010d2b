"""The c/p split of the card's SMs, checked on its own.

    python3 tools/sm_split.py [--theta 0.5] [--flags 2] [--clusters]

Splits the card at ``theta`` with ``repro_torch.kernels.green.split_sms``
(``--flags``: the ``cuDevSmResourceSplitByCount`` flags) and prints, for
each core: its SMs, the SM probe's set of SMs eagerly on the core's stream
and in a graph captured on the core's capture stream and replayed on a
plain stream and on the core's (``green.probe_set``), whether the two
cores' sets are disjoint and of the right sizes, and the clusters of 1-16
blocks the core holds at once by the occupancy calculator beside the whole
card's.  An event recorded on one core and waited on by the other orders a
PyTorch op across them.  ``--clusters`` also launches the probe in
clusters of 2-16 blocks on each core (a refusal is printed).  One JSON line
of it all is printed last and written to
``chiprun_out/sm_split_<theta>_<flags>.json``.  Each path kernel's time on
its core's partition is measured by ``chip_smoke.py`` (phase 2).  Needs a
card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import green  # noqa: E402
from repro_torch.kernels.util import kernel_library  # noqa: E402

CLUSTERS = (1, 2, 4, 8, 16)


def probe_core(dev, part, total: int) -> dict:
    """The probe's SM sets on ``part`` eagerly and in a replayed graph (on
    a plain stream and on the core's), and the clusters the partition
    holds."""
    eager = green.probe_set(dev, part.stream, 4 * total)
    with torch.cuda.stream(part.stream):
        clusters = {n: green.max_active_clusters(dev, n) for n in CLUSTERS}
    replays = {name: green.probe_set(dev, stream, 4 * total,
                                     capture=part.capture)
               for name, stream in (("plain", torch.cuda.Stream(dev)),
                                    ("core", part.stream))}
    return dict(sms=part.sms, eager=eager, replays=replays,
                clusters=clusters)


def cross_core_event(dev, split) -> bool:
    """A tensor written on the c-core, read on the p-core behind an event."""
    c, p = split.parts["c"].stream, split.parts["p"].stream
    with torch.cuda.stream(c):
        torch.cuda._sleep(2_000_000)
        x = torch.arange(1 << 20, device=dev, dtype=torch.float32)
        ev = torch.cuda.Event()
        ev.record(c)
    with torch.cuda.stream(p):
        p.wait_event(ev)
        y = x * 2
    p.synchronize()
    return bool(torch.equal(y.cpu(), torch.arange(1 << 20).float() * 2))


def cluster_launches(dev, split) -> dict:
    """The SMs the probe ran on in clusters of 2-16 blocks on each core,
    or the launch's refusal."""
    out = {}
    for core, part in split.parts.items():
        got = {}
        for n in CLUSTERS[1:]:
            try:
                got[n] = len(green.probe_set(dev, part.stream, n * part.sms,
                                             cluster=n))
            except RuntimeError as err:
                got[n] = str(err)
            print(f"[clusters] {core}: cluster {n}: {got[n]}", flush=True)
        out[core] = got
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--theta", type=float, default=0.5)
    ap.add_argument("--flags", type=int, default=green.SPLIT_FLAGS)
    ap.add_argument("--clusters", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sm_split: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    kernel_library()
    with torch.cuda.stream(torch.cuda.Stream(dev)):
        whole = {n: green.max_active_clusters(dev, n) for n in CLUSTERS}
    split = green.split_sms(dev, args.theta, flags=args.flags)
    report = dict(card=cs.card_line(), theta=args.theta, flags=args.flags,
                  total=split.total, asked=split.asked,
                  realised=split.theta, whole_clusters=whole)
    print(f"[split] theta {args.theta} flags {args.flags}: asked "
          f"{split.asked} of {split.total}, c {split.sms('c')} p "
          f"{split.sms('p')} (realised theta {split.theta:.4f})", flush=True)
    cores = {core: probe_core(dev, part, split.total)
             for core, part in split.parts.items()}
    report["cores"] = cores
    for core, r in cores.items():
        print(f"[probe] {core}: {r['sms']} SMs; eager {len(r['eager'])} "
              f"SMs {r['eager']}; replays "
              + ", ".join(f"{k}: {len(v)} SMs" for k, v in
                          r["replays"].items())
              + f"; clusters {r['clusters']} (whole card {whole})",
              flush=True)
    c, p = cores["c"], cores["p"]
    report["disjoint"] = {
        k: not set(c["replays"][k]) & set(p["replays"][k])
        for k in c["replays"]}
    report["disjoint"]["eager"] = not set(c["eager"]) & set(p["eager"])
    report["sizes_right"] = {
        core: [len(r["eager"]) == r["sms"]]
        + [len(v) == r["sms"] for v in r["replays"].values()]
        for core, r in cores.items()}
    report["event_across_cores"] = cross_core_event(dev, split)
    print(f"[probe] disjoint {report['disjoint']}, sizes right "
          f"{report['sizes_right']}, event across cores "
          f"{report['event_across_cores']}", flush=True)
    if args.clusters:
        report["cluster_launches"] = cluster_launches(dev, split)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"sm_split_{args.theta}_{args.flags}.json").write_text(
        json.dumps(report, indent=1))
    print(json.dumps({k: v for k, v in report.items() if k != "cores"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
