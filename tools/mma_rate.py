"""The card's rate for the products K7 flash is made of: mma.sync
m16n8k8 in TF32, and the 3xTF32 split beside it.

    python3 tools/mma_rate.py

Compiles a probe with ``nvcc`` (sm_90a) into ``build/mma_rate/`` and times
on the device, with CUDA events, three loops that every warp of a grid of
132 x N blocks runs (N blocks an SM, 4 warps each):

- ``mma``: 8 independent accumulators, each fed an m16n8k8 TF32 product
  per step, as the flash kernel's score tile is;
- ``mma+split``: the same, with each B fragment split into tf32 hi and
  lo by ``tc::split_tf32_bits`` first and three products a step (3xTF32);
- ``split``: the splits alone.

It prints each loop's rate (TFLOP/s of TF32 products, or splits a second)
for 1, 2 and 4 blocks an SM.  A measurement for the card only: nothing in
the package calls it.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels.util import CSRC, find_nvcc  # noqa: E402

SOURCE = r"""
#include "tc_common.cuh"

template <int MODE>
__global__ void __launch_bounds__(128) probe(float* out, int steps,
                                             float seed) {
  float acc[8][4] = {};
  uint32_t a[4];
  for (int i = 0; i < 4; ++i) a[i] = tc::to_tf32(seed + threadIdx.x + i);
  float b = seed * threadIdx.x;
  uint32_t sink = 0;
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t bh[2], bl[2];
      if (MODE == 0) {
        bh[0] = __float_as_uint(b + j);
        bh[1] = __float_as_uint(b - j);
        tc::mma_tf32(acc[j], a, bh);
      } else {
        tc::split_tf32_bits(b + j, bh[0], bl[0]);
        tc::split_tf32_bits(b - j, bh[1], bl[1]);
        if (MODE == 1) {
          tc::mma_tf32(acc[j], a, bh);
          tc::mma_tf32(acc[j], a, bl);
          tc::mma_tf32(acc[j], a, bh);
        } else {
          sink ^= bh[0] + bl[0] + bh[1] + bl[1];
        }
      }
    }
    b += 1.0f;
  }
  float r = __uint_as_float(sink);
  for (int j = 0; j < 8; ++j)
    r += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = r;
}

extern "C" int run(int mode, int blocks, int steps, float* out) {
  if (mode == 0) probe<0><<<blocks, 128>>>(out, steps, 1.5f);
  else if (mode == 1) probe<1><<<blocks, 128>>>(out, steps, 1.5f);
  else probe<2><<<blocks, 128>>>(out, steps, 1.5f);
  return (int)cudaGetLastError();
}
"""
MODES = ("mma", "mma+split", "split")
STEPS = 4096


def main() -> int:
    if not torch.cuda.is_available():
        print("mma_rate: no CUDA device", file=sys.stderr)
        return 1
    print(f"card: {cs.card_line()}")
    build = ROOT / "build" / "mma_rate"
    build.mkdir(parents=True, exist_ok=True)
    src, lib = build / "probe.cu", build / "libprobe.so"
    src.write_text(SOURCE)
    subprocess.run([find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
                    "-I", str(CSRC), "-o", str(lib), str(src)], check=True)
    probe = ctypes.CDLL(str(lib))
    probe.run.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    for per_sm in (1, 2, 4):
        blocks = 132 * per_sm
        out = torch.empty(blocks * 128, device="cuda")
        for mode, name in enumerate(MODES):
            probe.run(mode, blocks, 64, out.data_ptr())       # warm-up
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            rc = probe.run(mode, blocks, STEPS, out.data_ptr())
            end.record()
            torch.cuda.synchronize()
            if rc:
                raise RuntimeError(f"probe {name}: CUDA error {rc}")
            s = start.elapsed_time(end) / 1e3
            warps = blocks * 4
            if name == "split":
                rate = f"{warps * 32 * STEPS * 8 * 2 / s / 1e12:.3f} T " \
                       f"splits/s"
            else:
                mmas = warps * STEPS * 8 * (3 if name == "mma+split" else 1)
                rate = f"{mmas * 2 * 16 * 8 * 8 / s / 1e12:.1f} TFLOP/s " \
                       f"TF32 ({mmas / s / 132 / 1e9:.3f} G mma/s an SM)"
            print(f"{per_sm} blocks of 4 warps an SM, {name:<9}: "
                  f"{s * 1e3:.3f} ms, {rate}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
