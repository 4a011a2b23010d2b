"""K7 decode's outputs at ``chip_smoke.py`` phase 2's decode shapes in two
checkouts of this repository, compared bit for bit.

    python3 tools/decode_bits.py OTHER_TREE [--out NAME.json]

Takes phase 2's K7 decode calls from this checkout's ``chip_smoke.py``
(the LM path's at each planned group size, the other configs' head
geometry, whole and ragged, and the edge cases), draws each call's q, k, v
(and ``kv_len``) from a seed of its own with numpy, and runs them through
the decode wrapper of each tree in a process of its own (``--dump``), each
tree building its own kernel library.  Prints, for each head width, how
many calls there are and how many differ in any bit; exits 1 if any call
differs.  Calls the other tree's kernel cannot take (a head width it
refuses) are counted apart.  Run it on a parent unpacked with ``git
archive`` under ``build/`` to check that a change to the kernel leaves the
bits of the shapes that ran before as they were.  A check for the card
only: nothing in the package calls it.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from collections import Counter
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def calls() -> list[dict]:
    """Phase 2's K7 decode calls, from this checkout's ``chip_smoke.py``."""
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    out = []
    for size in sorted(set(cs.lm_group_sizes())):
        out += cs.lm_decode_calls(cs.LM_BATCH * size)
    out += cs.lm_geometry_calls() + cs.lm_edge_calls()
    out += cs.lm_geometry_edge_calls() + cs.block_calls() \
        + cs.block_edge_calls()
    return [c for c in out if c["kernel"] == "decode_attention"]


def dump(tree: Path, calls_path: Path, out_path: Path) -> None:
    """Run every call through ``tree``'s decode wrapper; save the outputs
    (None where the wrapper refuses the call)."""
    sys.path.insert(0, str(tree / "src"))
    import numpy as np
    import torch

    from repro_torch.kernels.attention.kernel import decode_attention
    outs = []
    for i, c in enumerate(json.loads(calls_path.read_text())):
        rng = np.random.default_rng(1000 + i)
        b, hq, hkv, sk, d, cap = (c[k] for k in ("b", "hq", "hkv", "sk", "d",
                                                 "cap"))

        def draw(*shape):
            return torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).cuda()

        q, k, v = draw(b, hq, 1, d), draw(b, hkv, cap, d), draw(b, hkv, cap,
                                                              d)
        lens = c.get("kv_len")
        kv_len = (None if lens is None else
                  torch.tensor(lens, dtype=torch.int32, device="cuda"))
        try:
            outs.append(decode_attention(q, k[:, :, :sk], v[:, :, :sk],
                                         kv_len).cpu())
        except ValueError:
            outs.append(None)
    torch.save(outs, out_path)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree", help="the other checkout")
    ap.add_argument("--out", default="decode_bits.json")
    ap.add_argument("--dump", nargs=3, metavar=("TREE", "CALLS", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.dump:
        dump(Path(args.dump[0]).resolve(), Path(args.dump[1]),
             Path(args.dump[2]))
        return 0
    import torch
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    todo = calls()
    calls_path = out_dir / "decode_bits_calls.json"
    calls_path.write_text(json.dumps(todo))
    trees = {"other": Path(args.tree).resolve(), "this": HERE}
    results = {}
    for name, tree in trees.items():
        path = out_dir / f"decode_bits_{name}.pt"
        subprocess.run([sys.executable, __file__, "x", "--dump", str(tree),
                        str(calls_path), str(path)], check=True)
        results[name] = torch.load(path)
    total, same, refused = Counter(), Counter(), Counter()
    rows = []
    for c, a, b in zip(todo, results["other"], results["this"]):
        if b is None:
            raise AssertionError(f"this tree refuses {c}")
        d = c["d"]
        total[d] += 1
        if a is None:
            refused[d] += 1
            continue
        eq = bool(torch.equal(a, b))
        same[d] += eq
        rows.append(dict(c, bit_equal=eq))
    for d in sorted(total):
        print(f"[decode_bits] D {d}: {total[d]} calls, {same[d]} bit-equal, "
              f"{total[d] - same[d] - refused[d]} differ, {refused[d]} "
              f"refused by {args.tree}")
    (out_dir / args.out).write_text(json.dumps(dict(
        total=total, same=same, refused=refused, rows=rows), indent=1))
    return 0 if all(same[d] + refused[d] == total[d] for d in total) else 1


if __name__ == "__main__":
    sys.exit(main())
