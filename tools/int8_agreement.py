"""Greedy tokens over an int8 KV cache against an f32 cache, in the JAX
reference and in the port, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/int8_agreement.py \\
        [--arch qwen2_5_14b] [--prompts 8 64 512] [--steps 16]

For each prompt length, draws the smoke config's weights from the
reference's ``init_params`` (key 0), carries them to the port, and runs
each package's ``make_generate`` from one seeded 2-row prompt over an f32
cache and over an int8 cache (``init_cache(kv_dtype=int8)``).  Prints the
share of tokens the int8 cache's greedy decode shares with the f32
cache's, in each package, and whether the port's tokens equal the
reference's.  The reference's own test (``tests/test_serving.py``) asks
for at least half at an 8-token prompt; the static scales round q to
1/32 and each probability to 1/127, so at long prompts most of a row's
probabilities round to 0, which this script shows for both packages.
A CPU tool: it imports both packages, as the tests do.
"""
from __future__ import annotations

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.registry import get_smoke as ref_get_smoke
from repro.lm import model as ref_model
from repro.lm import steps as ref_steps
from repro_torch.configs.registry import get_smoke
from repro_torch.lm import model, steps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tools/int8_agreement.py")
    ap.add_argument("--arch", default="qwen2_5_14b")
    ap.add_argument("--prompts", type=int, nargs="+", default=[8, 64, 512])
    ap.add_argument("--steps", type=int, default=16)
    args = ap.parse_args(argv)
    rcfg, cfg = ref_get_smoke(args.arch), get_smoke(args.arch)
    rparams = ref_model.init_params(rcfg, jax.random.PRNGKey(0))
    params = model.params_from_numpy(jax.tree.map(np.asarray, rparams),
                                     "cpu")
    ref_gen = ref_steps.make_generate(rcfg, args.steps)
    gen = steps.make_generate(cfg, args.steps)
    for plen in args.prompts:
        prompt = np.random.default_rng(27).integers(0, cfg.vocab, (2, plen))
        cap = plen + args.steps
        ref = {}
        port = {}
        for tag, rkv, kv in (("f32", None, None),
                             ("int8", jnp.int8, torch.int8)):
            ref[tag] = np.asarray(ref_gen(rparams, jnp.asarray(prompt),
                                          ref_model.init_cache(
                                              rcfg, 2, cap, kv_dtype=rkv))[0])
            port[tag] = gen(params, torch.from_numpy(prompt),
                            model.init_cache(cfg, 2, cap, "cpu",
                                             kv_dtype=kv))[0].numpy()
        print(f"prompt {plen}: int8 against f32 cache, reference "
              f"{(ref['int8'] == ref['f32']).mean():.3f}, port "
              f"{(port['int8'] == port['f32']).mean():.3f}; port tokens "
              f"equal the reference's: f32 "
              f"{bool((port['f32'] == ref['f32']).all())}, int8 "
              f"{bool((port['int8'] == ref['int8']).all())}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
