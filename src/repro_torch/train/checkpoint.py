"""Checkpoints with atomic commits, in the reference's layout.

Port of ``repro/train/checkpoint.py``.  Layout (one directory per step):

    ckpt_dir/
      step_00000100/
        manifest.json        # step, time, leaf count, shapes, dtypes
        shard_<host>.npz     # leaf_<i>: the state's leaves, in order
      LATEST                 # atomically-updated pointer

The leaves are stored in ``jax.tree.flatten`` order (``train/tree.py``:
NamedTuple fields in order, dict keys sorted, the per-layer views left
out), so a checkpoint written by either package restores in the other.

Fault-tolerance properties, as the reference's:
  * atomic commit: the shard and the manifest land in step_NNN.tmp, then
    one rename; a crash mid-save never corrupts LATEST.
  * keep-last-k garbage collection.
  * restore places the leaves on the device the caller names (the
    reference's ``shardings``: one card has one placement).
"""
from __future__ import annotations

import json
import os
import shutil
import time

import numpy as np
import torch

from repro_torch.train.tree import leaves, unflatten


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str, state, step: int, keep: int = 3,
         host_id: int = 0, blocking: bool = True) -> str:
    """Atomically write a checkpoint of ``state`` for ``step``; returns
    its directory.  (``blocking`` is the reference's; saves block.)"""
    tmp = os.path.join(ckpt_dir, f"step_{step:08d}.tmp")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(tmp, exist_ok=True)
    arrays = {f"leaf_{i}": _numpy(leaf)
              for i, leaf in enumerate(leaves(state))}
    np.savez(os.path.join(tmp, f"shard_{host_id}.npz"), **arrays)
    manifest = {
        "step": step,
        "time": time.time(),
        "n_leaves": len(arrays),
        "shapes": [list(np.shape(a)) for a in arrays.values()],
        "dtypes": [str(np.asarray(a).dtype) for a in arrays.values()],
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if not os.path.exists(final):
        os.replace(tmp, final)
    if os.path.exists(tmp):
        shutil.rmtree(tmp, ignore_errors=True)
    with open(os.path.join(ckpt_dir, "LATEST.tmp"), "w") as f:
        f.write(os.path.basename(final))
    os.replace(os.path.join(ckpt_dir, "LATEST.tmp"),
               os.path.join(ckpt_dir, "LATEST"))
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> int | None:
    p = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        name = f.read().strip()
    if not os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
        return None
    return int(name.split("_")[1])


def restore(ckpt_dir: str, reference_state, step: int | None = None,
            device: str | torch.device | None = None, host_id: int = 0):
    """Restore into the structure of ``reference_state`` (a state of
    tensors, possibly on the ``meta`` device: ``lm/steps.py``'s
    ``state_shapes``), each leaf cast to the reference leaf's dtype and
    placed on ``device`` (default: the reference leaf's device, which
    must then hold memory)."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with np.load(os.path.join(d, f"shard_{host_id}.npz")) as z:
        arrays = [z[f"leaf_{i}"] for i in range(len(z.files))]
    refs = leaves(reference_state)
    if len(arrays) != len(refs):
        raise ValueError(f"checkpoint {d} holds {len(arrays)} leaves, the "
                         f"state has {len(refs)}")
    placed = []
    for a, ref in zip(arrays, refs):
        dev = torch.device(device) if device is not None else ref.device
        if dev.type == "meta":
            raise ValueError("restore: name a device for a meta reference")
        # a copy in PyTorch's own allocation: a CPU kernel's vector loop
        # may round its unaligned head otherwise, and a replay differ
        a = np.require(a, requirements=("C", "W"))
        placed.append(torch.from_numpy(a).to(device=dev, dtype=ref.dtype,
                                             copy=True))
    return unflatten(reference_state, placed)
