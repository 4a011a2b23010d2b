"""Shared helpers of the port's kernel packages.

Counterpart of ``repro/kernels/util.py``: ``cdiv`` and the fused-epilogue
``apply_act``; a CUDA-event timer in place of ``bench_best_us``; the
device rule every entry point follows (``resolve_device``); and the build,
load and launch plumbing of the hand-written CUDA kernels under
``src/repro_torch/csrc/``.

The kernels are compiled at first use by ``nvcc`` into one shared library
with a plain C interface and called through ``ctypes``: each ``.cu`` file
is compiled on its own, all at once, then linked.  The library lands in
``build/repro_torch/<hash of the sources>/`` at the root of the checkout,
so a changed source rebuilds and an unchanged one loads what is there.
Every failure (no ``nvcc``, a compile error, a refused launch) raises:
nothing falls back to the plain versions on a CUDA tensor.

Every wrapper counts its launches in its ``launches`` attribute and is
registered with :func:`counted`.  :func:`capture_graph` records a body's
launches into a CUDA graph (the port's counterpart of ``jax.jit``): the
counts the wrappers took while capturing are taken back off, since a
capture launches nothing, and the graph carries them, adding them again at
each :meth:`CountedGraph.replay`.  So the counts read the same with graphs
or without.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import gc
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Any, Callable

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "librepro_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

ACT_CODES = {None: 0, "relu": 1, "relu6": 2, "silu": 3, "sigmoid": 4}
# cycles of ``torch.cuda._sleep`` per millisecond, at 2 GHz (above the
# H100's top SM clock, so a sleep lasts at least as long as asked)
SLEEP_CYCLES_PER_MS = 2_000_000


def cdiv(a: int, b: int) -> int:
    """Ceiling division (grid sizing)."""
    return -(-a // b)


def apply_act(x: torch.Tensor, act: str | None) -> torch.Tensor:
    """The shared fused-epilogue activation (None | 'relu' | 'relu6' |
    'silu' | 'sigmoid')."""
    if act == "relu":
        return torch.clamp_min(x, 0.0)
    if act == "relu6":
        return torch.clamp(x, 0.0, 6.0)
    if act == "silu":
        return torch.nn.functional.silu(x)
    if act == "sigmoid":
        return torch.sigmoid(x)
    if act is None:
        return x
    raise ValueError(f"unknown activation {act!r}")


def act_code(act: str | None) -> int:
    """The C kernels' activation code for ``act``."""
    try:
        return ACT_CODES[act]
    except KeyError:
        raise ValueError(f"unknown activation {act!r}") from None


def resolve_device(device: str | torch.device) -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` needs a card and
    raises without one: entry points run on the CPU only when the caller
    passes ``device="cpu"``, and on ``meta`` (shapes and counts, no
    memory: the dry run, ``launch/dryrun.py``) only when it passes
    ``device="meta"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to "
                           "run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; use 'cuda', 'cpu' or "
                         f"'meta'")
    if dev.type == "cuda" and dev.index is None:
        # name the card by index, so it compares equal to a tensor's device
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def cuda_time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device time of one ``fn()`` call on the current stream, in ms: CUDA
    events around ``reps`` back-to-back calls, over ``reps``, after
    ``warmup`` untimed calls.

    A sleep kernel queued ahead of the start event holds the device while
    the host enqueues every call, so the host's launch overhead is not
    counted.  If the device reached the start event before the last call
    was queued, the measurement is repeated with a longer sleep and half
    the calls: the host may have waited on a full launch queue (about a
    thousand pending launches), which a longer sleep cannot cure.  Inputs
    stay where the previous call left them (in L2 at the path's sizes)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    sleep_ms = 2.0 * reps * host_ms + 1.0
    for _ in range(8):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(sleep_ms * SLEEP_CYCLES_PER_MS))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        ahead = not start.query()     # the device is still asleep
        end.synchronize()
        if ahead:
            return start.elapsed_time(end) / reps
        sleep_ms *= 2                 # 4x the sleep per call
        reps = max(1, reps // 2)
    raise RuntimeError("cuda_time_ms: the device caught up with the host "
                       "under every sleep; does fn() synchronise?")


# --------------------------------------------------------------------------
# build and load
# --------------------------------------------------------------------------
def find_nvcc() -> str:
    """``nvcc`` from ``CUDA_HOME``, then ``PATH``, then /usr/local/cuda."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(Path(on_path))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be "
                       "built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    """Hash of every kernel source and header, and of the nvcc flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_library() -> Path:
    """Compile the kernels (one ``nvcc`` per source, all in parallel), link
    them into one shared library, and return its path.  Reuses a library
    already built from identical sources.  Each source's compiler output
    (``-Xptxas -v``: registers, shared memory, spills) is kept beside the
    library as ``<source stem>.log``."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        errors = []
        for src, _obj, proc in procs:
            log, _ = proc.communicate()
            (out_dir / f"{src.stem}.log").write_text(log)
            if proc.returncode != 0:
                errors.append(f"{src.name}:\n{log}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_lib),
             *(str(obj) for _src, obj, _p in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib)       # atomic: a racing build sees all
    return lib                         # or nothing


# C signatures: 'p' a pointer (or NULL), 'i' an int, 'l' a long long, 'f' a
# float, 's' the stream.
SIGNATURES = {
    "repro_matmul_bias_act": "p" * 4 + "i" * 12 + "s",
    "repro_conv2d_implicit_gemm": "p" * 4 + "i" * 20 + "s",
    "repro_depthwise_conv2d": "p" * 4 + "i" * 17 + "s",
    "repro_fused_dw_pw_conv": "p" * 7 + "i" * 19 + "s",
    "repro_fused_pw_dw_pw_conv": "p" * 9 + "i" * 23 + "s",
    "repro_rmsnorm": "p" * 3 + "i" * 2 + "f" + "i" + "s",
    "repro_rmsnorm_bwd": "p" * 6 + "i" * 3 + "f" + "s",
    "repro_flash_attention": "p" * 5 + "i" * 10 + "f" + "i" * 5 + "s",
    "repro_flash_attention_bwd": "p" * 10 + "i" * 10 + "f" + "i" * 8 + "s",
    "repro_decode_attention": "p" * 5 + "i" * 11 + "f" + "s",
    "repro_flash_attention_int8": "p" * 4 + "i" * 10 + "f" + "i" * 2 + "s",
    "repro_decode_attention_int8": "p" * 5 + "i" * 6 + "f" + "i" * 3 + "s",
    "repro_se_gate": "p" * 6 + "i" * 7 + "s",
    "repro_se_scale": "p" * 2 + "i" * 4 + "s",
    "repro_sm_probe": "p" + "i" * 2 + "l" + "s",
    "repro_sm_probe_clusters": "i" + "p" + "s",
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "l": ctypes.c_longlong,
           "f": ctypes.c_float, "s": ctypes.c_void_p}


def ptxas_report(stem: str) -> list[str]:
    """The ``-Xptxas -v`` lines (registers, spills) of source ``stem``'s
    kernels in the built library."""
    log = BUILD_ROOT / source_hash() / f"{stem}.log"
    return [ln.strip() for ln in log.read_text().splitlines()
            if "Compiling entry" in ln or "registers" in ln
            or "spill" in ln]


@functools.cache
def kernel_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every entry's
    argument types declared.  Raises if the build or the load fails."""
    lib = ctypes.CDLL(str(build_library()))
    for name, sig in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = [_CTYPES[c] for c in sig]
        fn.restype = ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def timed_build() -> float:
    """Build and load the kernel library; return the seconds it took."""
    t0 = time.perf_counter()
    kernel_library()
    return time.perf_counter() - t0


# --------------------------------------------------------------------------
# launching
# --------------------------------------------------------------------------
def check_cuda_operands(name: str, device: torch.device,
                        **tensors: torch.Tensor | None) -> None:
    """Raise unless every given tensor is a contiguous float32 tensor on
    ``device`` (a CUDA device)."""
    if device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA or CPU tensor, got "
                         f"{device}")
    for key, t in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected "
                             f"{device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {key} is {t.dtype}, expected float32")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def launch(entry: str, device: torch.device, *args) -> None:
    """Call the C entry ``entry`` on the current stream of ``device``.
    Tensors pass as device pointers, None as NULL; raises on a tensor past
    the kernels' 32-bit element indexing, and on a non-zero ``cudaError_t``
    (a refused launch never runs, and no later synchronisation would
    report it).

    Raises, too, where autograd records and a tensor argument requires
    grad: the C call fills its outputs with no gradient, so a gradient
    would be lost without a word.  The differentiable wrappers launch
    from inside a ``torch.autograd.Function``'s forward or backward,
    where grad mode is off."""
    grad = torch.is_grad_enabled()
    for a in args:
        if not isinstance(a, torch.Tensor):
            continue
        if a.numel() >= 2 ** 31:
            raise ValueError(f"{entry}: a tensor of {a.numel()} elements is "
                             f"past the kernels' 32-bit indexing")
        if grad and a.requires_grad:
            raise RuntimeError(f"{entry}: an operand requires grad while "
                               f"autograd records; the kernel's output "
                               f"would carry no gradient")
    lib = kernel_library()
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args]
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = getattr(lib, entry)(*c_args, stream)
    if rc != 0:
        msg = lib.repro_error_string(rc).decode()
        raise RuntimeError(f"{entry} failed: CUDA error {rc} ({msg})")


# --------------------------------------------------------------------------
# launch counts and captured graphs
# --------------------------------------------------------------------------
#: every kernel wrapper, by name (registered by :func:`counted`)
COUNTED: dict[str, Callable] = {}


def counted(fn: Callable) -> Callable:
    """Register kernel wrapper ``fn`` and start its launch count at 0."""
    fn.launches = 0
    COUNTED[fn.__name__] = fn
    return fn


def launch_counts() -> dict[str, int]:
    """Each registered wrapper's launch count, by name."""
    return {name: fn.launches for name, fn in COUNTED.items()}


# --------------------------------------------------------------------------
# operations of the kernels on ``meta``
# --------------------------------------------------------------------------
class MetaOps:
    """The operations the kernels' wrappers would have launched on
    ``meta`` tensors while this counter is open (:func:`meta_ops`), by
    wrapper, each counted as ``chip_smoke.py``'s bounds count it."""

    def __init__(self):
        self.by_kernel: dict[str, int] = {}

    @property
    def total(self) -> int:
        return sum(self.by_kernel.values())


_OPEN_META_OPS: list[MetaOps] = []


@contextlib.contextmanager
def meta_ops():
    """Open a :class:`MetaOps` counter for the body; counters nest, and
    every open one counts."""
    ops = MetaOps()
    _OPEN_META_OPS.append(ops)
    try:
        yield ops
    finally:
        _OPEN_META_OPS.remove(ops)


def add_meta_ops(name: str, ops: int) -> None:
    """Count ``ops`` operations of wrapper ``name`` in every open counter:
    a wrapper's ``meta`` branch, which allocates its outputs and launches
    nothing."""
    for counter in _OPEN_META_OPS:
        counter.by_kernel[name] = counter.by_kernel.get(name, 0) + int(ops)


class CountedGraph:
    """A captured CUDA graph and the launches of each wrapper in it.
    :meth:`replay` launches the graph on the current stream and adds those
    launches to the wrappers' counts."""

    def __init__(self, graph: torch.cuda.CUDAGraph,
                 launches: dict[str, int]):
        self.graph = graph
        self.launches = launches

    def replay(self) -> None:
        """Launch the graph on the current stream; count its launches."""
        self.graph.replay()
        for name, n in self.launches.items():
            COUNTED[name].launches += n


def capture_graph(body: Callable[[], Any], *, stream: torch.cuda.Stream,
                  pool=None, debug: bool = False) -> tuple[CountedGraph, Any]:
    """Capture ``body()`` into a CUDA graph on ``stream`` (a side stream)
    from the memory pool ``pool`` (a new private one when None); return
    the graph and what ``body`` returned, whose tensors are the graph's
    static outputs.

    Nothing runs while capturing, so the launches the wrappers count in
    ``body`` are taken back off and carried by the graph.  Unlike
    ``torch.cuda.graph`` this neither synchronises the device nor empties
    the allocator's cache, though a capture can still wait until the card
    is idle (``tools/capture_wait.py``).  The kernel
    library is loaded first (a build may not happen under capture); the
    kernels' own attributes (``tc::opt_in``) must already be set, by an
    eager run of the same launches.  Any failure raises: a failed capture
    is ended and discarded.  ``debug`` keeps the captured graph (not
    instantiated until a replay) for ``graph.debug_dump``."""
    kernel_library()
    graph = torch.cuda.CUDAGraph(keep_graph=debug)
    if debug:
        graph.enable_debug_mode()
    before = launch_counts()
    # a garbage collection inside the capture could destroy another graph
    # or release its memory pool, calls that CUDA refuses while a capture
    # runs (and that invalidate it): collect only after the capture
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=pool)
            try:
                out = body()
            except BaseException:
                _end_failed_capture(graph)
                raise
            graph.capture_end()
        after = launch_counts()
    finally:
        if collecting:
            gc.enable()
        for name, fn in COUNTED.items():
            fn.launches = before.get(name, 0)
    taken = {name: n - before.get(name, 0) for name, n in after.items()
             if n != before.get(name, 0)}
    return CountedGraph(graph, taken), out


def _end_failed_capture(graph: torch.cuda.CUDAGraph) -> None:
    """End a capture whose body raised.  CUDA then reports the capture
    invalidated, which says no more than the body's own error, so that
    report is dropped and the body's error propagates."""
    try:
        graph.capture_end()
    except RuntimeError:
        pass
