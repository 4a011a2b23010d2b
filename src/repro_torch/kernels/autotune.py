"""Cache of measured plans for the CNN kernels K1-K5 on the card.

Port of ``repro/kernels/autotune.py``.  Each CNN op builds its layer's
signature (:class:`LayerSig`) and asks this module for a plan before the
planner: a cached entry, measured on a card of the same name, compute
capability and SM count, gives the plan the op launches; a miss gives
the planner's pick (``plan_k1`` ... ``plan_k5``), as the port ran before
the cache.  The tuner times a few of the planner's own candidates once
per signature (:func:`tune`), caches the fastest in a JSON file, and
every later call (same process or another) launches it with no timing.

Cache format (the reference's, version 1)::

    {
      "version": 1,
      "entries": {
        "pointwise/h56.w56.ci64.co128.k1x1.s1.p0/f32/n2@cuda/NVIDIA H100
        80GB HBM3/sm90/sms64": {
          "config": {"bm": 64, "bn": 128, ...},
          "us": 12.345,
          "backend": "cuda/NVIDIA H100 80GB HBM3/sm90/sms64",
          "candidates_us": [[12.9, 13.0], [12.3, 12.4], ...]
        },
        ...
      }
    }

An entry's key is ``LayerSig.key()`` (byte for byte the reference's),
then what the port's plans depend on beyond the reference's signature
(the batch; K5's expand input channels; K3's 16-byte staging), then the
device tag (:func:`device_tag`): ``cpu``, or the card's name, its compute
capability and the SM count of the context the call is enqueued on, the
whole card's or a core's partition (``green.stream_sms``).  So one file
holds separate picks for the whole card and each core, and never collides
with the reference's entries, whose keys carry no tag.  ``us`` is the
winner's device time in µs (``cuda_time_ms`` on the current stream), or
null where every candidate failed; ``candidates_us`` each candidate's
runs, in :func:`candidates` order (null for one that raised).  The path
defaults to ``results/autotune_cache_torch.json`` (the reference's
``results/autotune_cache.json`` is its own) and ``REPRO_AUTOTUNE_CACHE``
redirects it, for both packages; :func:`save_cache` merges into the file
what is on disk, so neither package's entries are dropped by the other.

A candidate keeps the planner's reduction order, so a cached plan gives
the planner's bits: K1 and K3 the same ``k_splits``, K4 the same
``channel_splits``, K5 those and the same expand accumulator sets
(``fused_block/plan.py::expand_sets``); K2 has no split.  A cached config
that is not among its signature's candidates raises.

The ops' lookup (:func:`resolve`) is memoised per entry key and cache
generation (moved by every save and ``clear_memory_cache``), so the eager
path pays a dict lookup a launch.  The tuner (:func:`tune`, :func:`tune_layer`,
:func:`sweep_zoo`, ``python -m repro_torch.kernels.autotune --sweep-zoo``)
launches kernels and times them; call it outside a graph capture.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import time
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.kernels import green
from repro_torch.kernels.conv_gemm import plan as gemm_plan
from repro_torch.kernels.depthwise import plan as dw_plan
from repro_torch.kernels.fused_block import plan as fused_plan
from repro_torch.kernels.util import cuda_time_ms, resolve_device

CACHE_ENV = "REPRO_AUTOTUNE_CACHE"
CACHE_VERSION = 1
DEFAULT_PATH = os.path.join("results", "autotune_cache_torch.json")
#: candidates a signature is timed under: the planner's pick and 7 more
MAX_CANDIDATES = 8
#: back-to-back calls a timing run of a candidate takes on the card
CALLS = 10

_DTYPE_TAGS = {"float32": "f32", "bfloat16": "bf16", "float16": "f16"}

# in-memory mirror of the JSON files, keyed by resolved path
_MEM: dict[str, dict[str, Any]] = {}
# resolved plans, by (signature, card, stream's SMs, path, generation)
_PLANS: dict[tuple, tuple[Any, bool]] = {}
_GENERATION = 0

# when not None, every signature an op asks for is appended (how
# --sweep-zoo finds exactly the signatures the ops consult)
_RECORDING: list["LayerSig"] | None = None

#: lookups on the card since the last reset, by outcome
LOOKUPS = {"hit": 0, "miss": 0}


class LayerSig(NamedTuple):
    """Kernel-shape signature: the reference's ten fields, which
    :meth:`key` formats as the reference does, then what the port's plans
    also depend on, which only :meth:`entry_key` adds.  A named tuple
    where the reference has a frozen dataclass: the ops build one a
    launch, and a tuple is made and hashed in a fraction of the time."""

    kind: str                    # 'conv' | 'pointwise' | 'depthwise' |
                                 # 'fused_dw_pw' | 'fused_pw_dw_pw'
    H: int
    W: int
    C_i: int                     # K5: the expanded channels C_mid
    C_o: int
    K_h: int = 1
    K_w: int = 1
    stride: int = 1
    pad: int = 0
    dtype: str = "float32"
    N: int = 1                   # images (K1's M is N*H*W)
    C_e: int = 0                 # K5: the expand's input channels
    vec: bool = False            # K3: the input staged in 16-byte copies

    def key(self) -> str:
        tag = _DTYPE_TAGS.get(self.dtype, self.dtype)
        return (f"{self.kind}/h{self.H}.w{self.W}.ci{self.C_i}.co{self.C_o}"
                f".k{self.K_h}x{self.K_w}.s{self.stride}.p{self.pad}/{tag}")

    def entry_key(self, tag: str) -> str:
        """The cache entry's key on device ``tag``."""
        extra = f"n{self.N}"
        if self.kind == "fused_pw_dw_pw":
            extra += f".ce{self.C_e}"
        elif self.kind == "conv":
            extra += f".v{int(self.vec)}"
        return f"{self.key()}/{extra}@{tag}"


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.float32`` -> ``"float32"``, the reference's dtype names."""
    return str(dtype).removeprefix("torch.")


# --------------------------------------------------------------------------
# the device tag
# --------------------------------------------------------------------------
@functools.cache
def _card(index: int) -> tuple[str, int]:
    props = torch.cuda.get_device_properties(index)
    return (f"cuda/{props.name}/sm{props.major}{props.minor}",
            props.multi_processor_count)


def _device(device) -> torch.device:
    """``device``, or the card where there is one and the CPU otherwise
    (the reference's default backend)."""
    if device is None:
        return resolve_device("cuda" if torch.cuda.is_available() else "cpu")
    return device if isinstance(device, torch.device) else \
        resolve_device(device)


def _index(dev: torch.device) -> int:
    return dev.index if dev.index is not None \
        else torch.cuda.current_device()


def _stream_sms(index: int) -> int | None:
    """The SMs of the partition the current stream of card ``index`` runs
    on, None for the whole card.  The stream's handle is read with the
    call ``torch.cuda.current_stream(...).cuda_stream`` makes, without
    building a Stream object: the ops ask at every launch."""
    return green.stream_sms(torch._C._cuda_getCurrentRawStream(index))


def device_tag(device=None) -> str:
    """``cpu``, or the card's name, compute capability and the SMs of the
    context the current stream of ``device`` runs on: a core's partition
    (its stream or its capture stream) or the whole card."""
    dev = _device(device)
    if dev.type != "cuda":
        return "cpu"
    index = _index(dev)
    card, total = _card(index)
    return f"{card}/sms{_stream_sms(index) or total}"


# --------------------------------------------------------------------------
# the file
# --------------------------------------------------------------------------
def cache_path(path: str | None = None) -> str:
    if path:
        return path
    return os.environ.get(CACHE_ENV) or DEFAULT_PATH


def _read(p: str) -> dict[str, Any] | None:
    try:
        with open(p) as f:
            raw = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(raw, dict) or raw.get("version") != CACHE_VERSION \
            or not isinstance(raw.get("entries"), dict):
        return None
    return raw


def load_cache(path: str | None = None) -> dict[str, Any]:
    p = cache_path(path)
    if p in _MEM:
        return _MEM[p]
    data = _read(p) or {"version": CACHE_VERSION, "entries": {}}
    _MEM[p] = data
    return data


def save_cache(data: dict[str, Any], path: str | None = None) -> None:
    """Write ``data`` to the file, over the entries the file holds now
    (another process's or the reference's are kept), and move the cache
    generation on."""
    global _GENERATION
    p = cache_path(path)
    on_disk = _read(p)
    merged = dict(on_disk["entries"]) if on_disk else {}
    merged.update(data["entries"])
    data["entries"] = merged
    data["version"] = CACHE_VERSION
    os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
    tmp = p + ".tmp"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
    os.replace(tmp, p)
    _MEM[p] = data
    _PLANS.clear()
    _GENERATION += 1


def clear_memory_cache() -> None:
    """Drop the in-process mirror and the resolved plans (tests use this
    to force a re-read)."""
    global _GENERATION
    _MEM.clear()
    _PLANS.clear()
    _GENERATION += 1


# --------------------------------------------------------------------------
# the planner's picks and candidates
# --------------------------------------------------------------------------
_KNOBS = {
    "pointwise": ("bm", "bn", "bk", "wm", "cluster", "stages",
                  "smem_bytes"),
    "conv": ("bm", "bn", "bk", "wm", "cluster", "stages", "smem_bytes"),
    "depthwise": ("th", "tw", "cq", "ow", "smem_bytes"),
    "fused_dw_pw": ("th", "tw", "cluster", "stages", "smem_bytes"),
    "fused_pw_dw_pw": ("th", "tw", "cluster", "stages", "kc", "group",
                       "smem_bytes"),
}


def _check_kind(sig: LayerSig) -> None:
    if sig.kind not in _KNOBS:
        raise ValueError(f"unknown kernel kind {sig.kind!r}")


def _out(sig: LayerSig) -> tuple[int, int]:
    return fused_plan.out_size(sig.H, sig.W, sig.K_h, sig.K_w, sig.stride,
                               sig.pad)


def planner_plan(sig: LayerSig):
    """The planner's pick at ``sig``: the plan the kernel's wrapper
    launches without a cache."""
    _check_kind(sig)
    s = sig
    if s.kind == "pointwise":
        return gemm_plan.plan_k1(s.N * s.H * s.W, s.C_i, s.C_o)
    if s.kind == "conv":
        return gemm_plan.plan_k3(s.N, s.H, s.W, s.C_i, s.C_o, s.K_h, s.K_w,
                                 s.stride, s.pad, s.vec)
    if s.kind == "depthwise":
        return dw_plan.plan_k2(s.N, s.H, s.W, s.C_i, s.K_h, s.K_w,
                               s.stride, s.pad)
    if s.kind == "fused_dw_pw":
        return fused_plan.plan_k4(s.N, s.H, s.W, s.C_i, s.C_o, s.K_h,
                                  s.stride, s.pad, s.K_w)
    return fused_plan.plan_k5(s.N, s.H, s.W, s.C_e, s.C_i, s.C_o, s.K_h,
                              s.stride, s.pad, s.K_w)


def _ranked(sig: LayerSig) -> list:
    """Every plan the planner considers at ``sig``, best first by its own
    sort key."""
    s = sig
    ho, wo = _out(s)
    if s.kind == "pointwise":
        kps = gemm_plan.candidates(s.N * s.H * s.W, s.C_i, s.C_o)
    elif s.kind == "conv":
        kps = gemm_plan.k3_candidates(s.N, s.H, s.W, s.C_i, s.C_o, s.K_h,
                                      s.K_w, s.stride, s.pad, s.vec)
    elif s.kind == "depthwise":
        kps = dw_plan.candidates(s.N, ho, wo, s.C_i, s.K_h, s.K_w, s.stride)
    elif s.kind == "fused_dw_pw":
        kps = fused_plan.candidates("k4", s.N, ho, wo, 0, s.C_i, s.C_o,
                                    s.K_h, s.K_w, s.stride)
    else:
        kps = fused_plan.candidates("k5", s.N, ho, wo, s.C_e, s.C_i, s.C_o,
                                    s.K_h, s.K_w, s.stride)
    return [p for _, p in sorted(kps, key=lambda kp: kp[0])]


def reduction_order(sig: LayerSig, plan) -> tuple | None:
    """What fixes the order a plan sums in at ``sig`` (two plans with the
    same order give the same bits): K1's and K3's ``k_splits``, K4's
    ``channel_splits``, K5's and its expand's accumulator sets; None for
    K2, whose sums do not depend on its tiling."""
    s = sig
    if s.kind == "pointwise":
        return gemm_plan.k_splits(s.C_i, plan.bk, plan.cluster)
    if s.kind == "conv":
        return gemm_plan.k_splits(s.K_h * s.K_w * s.C_i, plan.bk,
                                  plan.cluster)
    if s.kind == "depthwise":
        return None
    splits = fused_plan.channel_splits(s.C_i, plan.cluster)
    if s.kind == "fused_dw_pw":
        return splits
    return splits, fused_plan.expand_sets(plan.th, plan.tw, s.K_h, s.K_w,
                                          s.stride, plan.group)


def knobs(sig: LayerSig, plan) -> dict:
    """``plan`` as the config the cache stores: the knobs the kernel's C
    entry point takes."""
    return {k: getattr(plan, k) for k in _KNOBS[sig.kind]}


@functools.cache
def _candidate_plans(sig: LayerSig) -> tuple:
    pick = planner_plan(sig)
    order = reduction_order(sig, pick)
    out, seen = [pick], {json.dumps(knobs(sig, pick), sort_keys=True)}
    for p in _ranked(sig):
        if len(out) >= MAX_CANDIDATES:
            break
        k = json.dumps(knobs(sig, p), sort_keys=True)
        if k in seen or reduction_order(sig, p) != order:
            continue
        seen.add(k)
        out.append(p)
    return tuple(out)


def heuristic_config(sig: LayerSig) -> dict:
    """The planner's pick at ``sig``, as a config: what a miss launches."""
    return knobs(sig, planner_plan(sig))


def candidates(sig: LayerSig) -> list[dict]:
    """The configs :func:`tune` times at ``sig``: the planner's pick, then
    at most ``MAX_CANDIDATES - 1`` more of the planner's own candidates in
    its order, each with the pick's reduction order
    (:func:`reduction_order`)."""
    _check_kind(sig)
    return [knobs(sig, p) for p in _candidate_plans(sig)]


def plan_of(sig: LayerSig, config: dict, where: str = "") -> Any:
    """The candidate plan whose knobs are ``config``; raises a
    ``ValueError`` naming ``where`` (the entry and its file) when no
    candidate at ``sig`` has them."""
    for p in _candidate_plans(sig):
        if knobs(sig, p) == config:
            return p
    why = "is not among its candidates"
    for p in _ranked(sig):
        if knobs(sig, p) == config:
            why = ("sums in another order than the planner's pick "
                   f"({reduction_order(sig, p)} against "
                   f"{reduction_order(sig, planner_plan(sig))})")
            break
    raise ValueError(f"autotune: the cached config {config} of "
                     f"{where or sig.key()} {why}")


# --------------------------------------------------------------------------
# the lookup
# --------------------------------------------------------------------------
def _entry(sig: LayerSig, tag: str, path: str | None) -> dict | None:
    entry = load_cache(path)["entries"].get(sig.entry_key(tag))
    if not entry or entry.get("backend") != tag:
        return None
    return entry


def get_config(sig: LayerSig, path: str | None = None, *,
               device=None) -> dict | None:
    """Cached winning config for ``sig`` on ``device`` (default: the card
    where there is one, else the CPU), or None on a miss.  An entry of
    another tag (another card, another SM count, or the CPU) is a miss:
    a plan ranked on one says nothing about another."""
    if _RECORDING is not None:
        _RECORDING.append(sig)
    entry = _entry(sig, device_tag(device), path)
    return None if entry is None else dict(entry["config"])


def resolve(sig: LayerSig, device: torch.device, path: str | None = None):
    """The plan a call at ``sig`` launches on ``device``: on the card the
    cached config's plan, or the planner's on a miss (counted in
    ``LOOKUPS``); None on the CPU, where the wrappers run their plain
    versions.  Memoised per entry key and cache generation."""
    if _RECORDING is not None:
        _RECORDING.append(sig)
    if device.type != "cuda":
        return None
    index = _index(device)
    p = cache_path(path)
    # the card and its stream's SMs fix the tag, so the tag's string is
    # made only when the memo misses
    memo = (sig, index, _stream_sms(index), p, _GENERATION)
    got = _PLANS.get(memo)
    if got is None:
        tag = device_tag(device)
        entry = _entry(sig, tag, p)
        if entry is None:
            got = (planner_plan(sig), False)
        else:
            got = (plan_of(sig, dict(entry["config"]),
                           f"{sig.entry_key(tag)} in {p}"), True)
        _PLANS[memo] = got
    LOOKUPS["hit" if got[1] else "miss"] += 1
    return got[0]


def reset_lookups() -> None:
    """Set the lookup counts to 0."""
    LOOKUPS["hit"] = LOOKUPS["miss"] = 0


# --------------------------------------------------------------------------
# the tuner (launches kernels)
# --------------------------------------------------------------------------
def _time_us(fn: Callable[[], Any], dev: torch.device) -> float:
    """One timing run: on the card the device µs of a call
    (``cuda_time_ms`` over ``CALLS`` back-to-back calls on the current
    stream); on the CPU the wall µs of one call."""
    if dev.type == "cuda":
        return cuda_time_ms(fn, reps=CALLS, warmup=1) * 1e3
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e6


def tune(sig: LayerSig, run: Callable[[dict], Callable[[], Any]], *,
         path: str | None = None, reps: int = 3, force: bool = False,
         device="cuda") -> dict:
    """Time ``candidates(sig)`` on ``device`` and cache the fastest.

    ``run(config)`` returns a zero-arg callable launching the kernel with
    that config.  Each candidate gets ``reps`` timing runs and its best
    counts.  A cached entry short-circuits the timing unless ``force``; a
    candidate that raises is skipped; if every one fails, the planner's
    pick is cached with ``"us": null``."""
    dev = resolve_device(device)
    tag = device_tag(dev)
    if not force:
        hit = _entry(sig, tag, path)
        if hit is not None:
            return dict(hit["config"])
    best_cfg, best_us = None, float("inf")
    runs: list[list[float] | None] = []
    for cfg in candidates(sig):
        try:
            fn = run(cfg)
            times = [_time_us(fn, dev) for _ in range(max(1, reps))]
        except Exception:            # a candidate may fail at a shape
            runs.append(None)
            continue
        runs.append([round(t, 3) for t in times])
        if min(times) < best_us:
            best_cfg, best_us = cfg, min(times)
    if best_cfg is None:
        # every candidate failed: cache the pick with no timing (null
        # keeps the JSON strict: NaN is not valid JSON)
        best_cfg, best_us = heuristic_config(sig), None
    data = load_cache(path)
    data["entries"][sig.entry_key(tag)] = {
        "config": best_cfg,
        "us": None if best_us is None else round(best_us, 3),
        "backend": tag, "candidates_us": runs}
    save_cache(data, path)
    return dict(best_cfg)


def operands(sig: LayerSig, device) -> Callable[[Any], Callable[[], Any]]:
    """Seeded operands of ``sig``'s shape on ``device`` and the function
    that turns a plan into a zero-arg call of the kernel's wrapper (its
    plain version on the CPU)."""
    from repro_torch.kernels.conv_gemm.kernel import (conv2d_implicit_gemm,
                                                      matmul_bias_act)
    from repro_torch.kernels.depthwise.kernel import depthwise_conv2d
    from repro_torch.kernels.fused_block.kernel import (fused_dw_pw_conv,
                                                        fused_pw_dw_pw_conv)
    _check_kind(sig)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    s = sig

    def rnd(*shape, scale=0.3):
        return torch.randn(shape, generator=gen, device=dev) * scale

    ho, wo = _out(s)
    if s.kind == "pointwise":
        x, w, b = rnd(s.N * s.H * s.W, s.C_i), rnd(s.C_i, s.C_o), rnd(s.C_o)
        return lambda p: (lambda: matmul_bias_act(x, w, b, act="relu6",
                                                  plan=p))
    if s.kind == "conv":
        x = rnd(s.N, s.H, s.W, s.C_i)
        if not s.vec and s.C_i % 4 == 0:
            # 4-byte staging, as a call with a misaligned input takes
            x = torch.empty(x.numel() + 1, device=dev)[1:].view(
                x.shape).copy_(x)
        w, b = rnd(s.K_h, s.K_w, s.C_i, s.C_o), rnd(s.C_o)
        return lambda p: (lambda: conv2d_implicit_gemm(
            x, w, b, stride=s.stride, pad=s.pad, act="relu", plan=p))
    if s.kind == "depthwise":
        x, w, b = rnd(s.N, s.H, s.W, s.C_i), rnd(s.K_h, s.K_w, s.C_i), \
            rnd(s.C_i)
        return lambda p: (lambda: depthwise_conv2d(
            x, w, b, stride=s.stride, pad=s.pad, act="relu6", plan=p))
    if s.kind == "fused_dw_pw":
        x = rnd(s.N, s.H, s.W, s.C_i)
        dw_w, dw_b = rnd(s.K_h, s.K_w, s.C_i), rnd(s.C_i)
        pw_w, pw_b = rnd(s.C_i, s.C_o), rnd(s.C_o)
        return lambda p: (lambda: fused_dw_pw_conv(
            x, dw_w, dw_b, pw_w, pw_b, stride=s.stride, pad=s.pad,
            plan=p))
    x = rnd(s.N, s.H, s.W, s.C_e)
    exp_w, exp_b = rnd(s.C_e, s.C_i), rnd(s.C_i)
    dw_w, dw_b = rnd(s.K_h, s.K_w, s.C_i), rnd(s.C_i)
    proj_w, proj_b = rnd(s.C_i, s.C_o), rnd(s.C_o)
    # the path adds the block's input where its shape allows
    res = rnd(s.N, ho, wo, s.C_o) if s.stride == 1 and s.C_e == s.C_o \
        else None
    return lambda p: (lambda: fused_pw_dw_pw_conv(
        x, exp_w, exp_b, dw_w, dw_b, proj_w, proj_b, res, stride=s.stride,
        pad=s.pad, plan=p))


def tune_layer(sig: LayerSig, *, batch: int | None = None, device="cuda",
               path: str | None = None, reps: int = 3,
               force: bool = False) -> dict:
    """Tune one signature end to end: seeded operands of its shape (``batch``
    images, default ``sig.N``) on ``device`` (default the card; the CPU
    times the plain versions), each candidate through the kernel's
    wrapper."""
    if batch is not None:
        sig = sig._replace(N=batch)
    call = operands(sig, device)

    def run(cfg):
        return call(plan_of(sig, cfg))

    return tune(sig, run, path=path, reps=reps, force=force, device=device)


# --------------------------------------------------------------------------
# zoo sweep (python -m repro_torch.kernels.autotune --sweep-zoo)
# --------------------------------------------------------------------------
ZOO_MODELS = ("mobilenet_v1", "mobilenet_v2", "squeezenet")
#: the schedules whose group-fused exec plans the sweep runs: the serve
#: CLI's named schemes (its ``best``, Alg.1's load balance over them,
#: takes seconds of host a model and is left out)
GROUP_SCHEMES = ("layer_type", "greedy", "round_robin", "balanced")


@contextlib.contextmanager
def record_signatures():
    """Collect every LayerSig the ops consult inside the block."""
    global _RECORDING
    prev, _RECORDING = _RECORDING, []
    try:
        yield _RECORDING
    finally:
        _RECORDING = prev


@functools.cache
def _schedule(model: str, scheme: str):
    """``model``'s schedule under ``scheme`` on the baseline config, as
    ``serve cnn`` builds it (made once: it depends on neither the image
    size nor the batch)."""
    from repro_torch.core.arch import DUAL_BASELINE, BoardModel
    from repro_torch.core.scheduler import build_schedule
    from repro_torch.models.zoo import get_graph
    return build_schedule(get_graph(model), DUAL_BASELINE, BoardModel(),
                          scheme)


def zoo_signatures(image_size: int = 224,
                   models: tuple[str, ...] = ZOO_MODELS,
                   batch: int = 2, *,
                   group_schemes: tuple[str, ...] = GROUP_SCHEMES
                   ) -> list[LayerSig]:
    """Every layer signature the zoo's programs consult at ``image_size``
    and ``batch``, found by running them on the CPU with recording on:
    the per-layer and the fused program (``build_program(fuse=False /
    True)``), as the reference does, then the runner's group-fused exec
    plans (``fuse="group"``, its default) under each of
    ``group_schemes``, whose K4 and K5 calls the served path makes."""
    from repro_torch.dualcore.program import build_program
    from repro_torch.dualcore.runtime import DualCoreRunner
    from repro_torch.models.cnn import init_params, params_from_numpy
    from repro_torch.models.zoo import get_graph

    sigs: list[LayerSig] = []
    seen: set[LayerSig] = set()
    x = torch.zeros((batch, image_size, image_size, 3))
    for name in models:
        params = params_from_numpy(init_params(get_graph(name)), "cpu")
        runs = [build_program(name, fuse=f).run for f in (False, True)]
        for scheme in group_schemes:
            runner = DualCoreRunner(name, params, _schedule(name, scheme),
                                    device="cpu")
            runs.append(lambda _, xx, r=runner: r.run_sequential([xx]))
        for fn in runs:
            with torch.no_grad(), record_signatures() as rec:
                fn(params, x)
            for s in rec:
                if s not in seen:
                    seen.add(s)
                    sigs.append(s)
    return sigs


def sweep_zoo(image_size: int = 224, *, batch: int = 2, reps: int = 3,
              limit: int = 0, force: bool = False, path: str | None = None,
              device="cuda", models: tuple[str, ...] = ZOO_MODELS) -> dict:
    """Warm the cache over all zoo layer signatures on ``device``, for the
    SMs of the current stream.  ``limit`` bounds how many *missing*
    signatures are tuned this run (0 = all); cached entries always
    short-circuit.  Returns a summary dict (total / cached / tuned /
    skipped)."""
    dev = resolve_device(device)
    tag = device_tag(dev)
    sigs = zoo_signatures(image_size, models, batch)
    missing = [s for s in sigs if _entry(s, tag, path) is None]
    cached = [s for s in sigs if s not in missing]
    if force:
        missing, cached = sigs, []
    todo = missing if limit <= 0 else missing[:limit]
    for i, sig in enumerate(todo):
        cfg = tune_layer(sig, device=dev, path=path, reps=reps, force=force)
        us = load_cache(path)["entries"][sig.entry_key(tag)].get("us")
        won = "the pick" if cfg == heuristic_config(sig) else cfg
        print(f"[{i + 1:>3}/{len(todo)}] {sig.entry_key(tag)} -> {won} "
              f"({'n/a' if us is None else f'{us:.3f} us'})")
    summary = {"image_size": image_size, "batch": batch, "device": tag,
               "total": len(sigs), "cached": len(cached),
               "tuned": len(todo), "skipped": len(missing) - len(todo),
               "cache_path": cache_path(path)}
    print(f"sweep: {summary['total']} signatures @ {image_size}px, batch "
          f"{batch} on {tag}: {summary['cached']} already cached, "
          f"{summary['tuned']} tuned, {summary['skipped']} deferred "
          f"(limit) -> {summary['cache_path']}")
    return summary


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="repro_torch.kernels.autotune",
        description="Warm the plan cache of K1-K5 over the zoo.")
    ap.add_argument("--sweep-zoo", action="store_true", required=True,
                    help="tune every zoo layer signature into the cache")
    ap.add_argument("--image-size", type=int, default=None,
                    help="input H=W the signatures are taken at "
                         "(default: 224 paper size; 64 with --smoke)")
    ap.add_argument("--batch", type=int, default=2,
                    help="images a call (default 2, the serve CLI's)")
    ap.add_argument("--smoke", action="store_true",
                    help="quick bounds: 64px signatures, reps=1, --limit "
                         "12 unless overridden (incremental warming via "
                         "the persisted cache)")
    ap.add_argument("--reps", type=int, default=None,
                    help="timing runs per candidate (default 3; 1 smoke)")
    ap.add_argument("--limit", type=int, default=None,
                    help="max missing signatures tuned this run "
                         "(0 = all; default 0, 12 with --smoke)")
    ap.add_argument("--force", action="store_true",
                    help="re-tune even cached signatures")
    ap.add_argument("--cache", default=None,
                    help=f"cache file (default: ${CACHE_ENV} or "
                         f"{DEFAULT_PATH})")
    split_at = ap.add_mutually_exclusive_group()
    split_at.add_argument("--theta", type=float, default=None,
                          help="also tune under each core's stream of the "
                               "card's SM split at THETA (a runner given "
                               "theta=THETA serves there); on the card "
                               "only")
    split_at.add_argument("--c-sms", type=int, default=None,
                          help="also tune under each core's stream of the "
                               "split that gives the c-core C_SMS SMs (a "
                               "runner that measures its split names its "
                               "count on its cores line: 'c C_SMS SMs'); "
                               "on the card only")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: needs a card) or cpu (times the "
                         "plain versions; the card never reads such "
                         "entries)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    streams = [None]
    theta = args.theta
    if theta is not None or args.c_sms is not None:
        if dev.type != "cuda":
            ap.error("--theta and --c-sms split the card's SMs: they need "
                     "--device cuda")
        if theta is None:
            total = _card(_index(dev))[1]
            if green.granular_count(args.c_sms, total) != args.c_sms:
                ap.error(f"--c-sms {args.c_sms} is no count of {total} "
                         f"SMs in granules of {green.GRANULE}")
            theta = args.c_sms / total
        split = green.split_sms(dev, theta)
        streams += [split.parts[c].stream for c in "cp"]
    image_size = args.image_size or (64 if args.smoke else 224)
    reps = args.reps if args.reps is not None else (1 if args.smoke else 3)
    limit = args.limit if args.limit is not None else (12 if args.smoke
                                                      else 0)
    for stream in streams:
        with (contextlib.nullcontext() if stream is None
              else torch.cuda.stream(stream)):
            sweep_zoo(image_size, batch=args.batch, reps=reps, limit=limit,
                      force=args.force, path=args.cache, device=dev)
        if stream is not None:
            stream.synchronize()
    return 0


if __name__ == "__main__":
    import sys

    # run the *canonical* module instance: under ``python -m`` this file
    # executes as ``__main__``, whose module-level recording state would be
    # invisible to the ops importing ``repro_torch.kernels.autotune``
    from repro_torch.kernels.autotune import main as _main

    sys.exit(_main())
