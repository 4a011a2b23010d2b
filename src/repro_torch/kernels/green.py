"""Disjoint SM partitions of one card: CUDA green contexts.

The port's counterpart of the reference's Eq.10 ``split_mesh``
(``repro/dualmesh/partition.py``), which gives the c-submesh ``n_c =
min(n-1, max(1, round(theta*n)))`` of a pod's ``n`` chips and the p-submesh
the rest.  One card has SMs where the pod has chips: :func:`split_sms`
cuts the card's SMs into two disjoint sets, the c-core ``n_c`` of them by
the same formula and the p-core the remainder, each a green context of the
CUDA driver with its own streams.  Work queued on a partition's stream, or
captured there into a CUDA graph and replayed on any stream, runs on that
partition's SMs only.

The CUDA driver API is reached through ``ctypes`` on ``libcuda.so.1``, in the
order CUDA documents: ``cuDeviceGetDevResource`` (the card's SMs),
one ``cuDevSmResourceSplitByCount`` (one group of ``n_c`` SMs and the
remainder), ``cuDevResourceGenerateDesc`` and ``cuGreenCtxCreate`` for
each, and ``cuGreenCtxStreamCreate`` for each stream, wrapped as a
``torch.cuda.ExternalStream``.  The split's granularity is CUDA's:
on compute capability 9.0 a group is a multiple of 8 SMs
(``cuDevSmResourceSplitByCount`` in ``cuda.h``), so ``n_c`` is rounded to
one (:func:`granular_count`) and the count the call returns is what the
cores record (``theta = n_c / sms``, as the reference records ``n_c /
len(devs)``).  A missing symbol or a refused call raises
:class:`GreenContextError` naming the ``CUresult``: nothing falls back to
streams that share the card's SMs.  The split asks for groups that keep
clusters of 16 blocks (``SPLIT_FLAGS``), so every kernel plan, keyed to
the whole card, launches in either partition with the same bits.

:func:`balanced_count` picks the c-core's count from measured times in
place of a theta: the search a ``DualCoreRunner`` makes once, at its
first lane capture, over counts split here.  A count's split is the only
thing the search may find refused: a split that is made keeps clusters of
16, so every plan launches in it, and any other failure is a fault.

Each partition's SM count is recorded against its two streams' handles
(:func:`stream_sms`), so the plan cache (``kernels/autotune.py``) keys a
call by the SMs of the stream it is enqueued on; its plans for a
partition sum in the planner's order, so they keep those bits.

``torch.cuda.synchronize()`` does not wait for a graph replayed on a
partition's stream: wait on the stream (``DualCores.synchronize``) or on
an event recorded there.

A split is made once for each c-core count and kept for the life of the
process, contexts and streams: a split at a count made before returns the
same :class:`SmSplit`, so splitting again, in a resplit or a REBALANCE,
makes nothing new, and a graph captured in one of its partitions stays
valid.  Two users of one count share its streams, and their work on a
core queues in order, as the work of two reference pools on one chip
does.  Nothing is destroyed: PyTorch's caching allocator records an event
on every stream a tensor was used on (``record_stream``) when it frees the
tensor, at a time the port cannot know, and an event on a stream of a
destroyed context aborts the process.

Nothing here is loaded or called when the module is imported.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable

import torch

CU_DEV_RESOURCE_TYPE_SM = 1
CU_GREEN_CTX_DEFAULT_STREAM = 0x1
CU_STREAM_NON_BLOCKING = 0x1
#: a ``cuDevSmResourceSplitByCount`` flag (``CUdevSmResourceSplit_flags``)
SPLIT_MAX_POTENTIAL_CLUSTER_SIZE = 0x2
#: the flags every split is made with: groups that hold the clusters of 16
#: blocks the kernels' plans use (without the flag a group of an H100
#: holds clusters of at most 8, and a plan of 9-16 is refused at launch)
SPLIT_FLAGS = SPLIT_MAX_POTENTIAL_CLUSTER_SIZE
#: SMs a group is a multiple of on compute capability 9.0 (``cuda.h``)
GRANULE = 8
# ``CUdevResource``: a 4-byte type and 92 bytes of padding, then the union
# whose ``sm.smCount`` comes first; 144 bytes in CUDA 12's ``cuda.h``,
# room for later headers' trailing fields
RESOURCE_BYTES = 512
SM_COUNT_OFFSET = 96


class GreenContextError(RuntimeError):
    """``libcuda`` lacks green contexts or refused a split."""


# --------------------------------------------------------------------------
# the counts
# --------------------------------------------------------------------------
def reference_count(theta: float, sms: int) -> int:
    """The reference's ``n_c``: ``min(n-1, max(1, round(theta*n)))`` of
    ``n`` = ``sms`` (``split_mesh``, with SMs for chips)."""
    return min(sms - 1, max(1, round(theta * sms)))


def granular_count(n_c: int, sms: int, granule: int = GRANULE) -> int:
    """``n_c`` rounded to the nearest multiple of ``granule`` (halves up),
    leaving each core at least one granule of the ``sms``."""
    if sms < 2 * granule:
        raise ValueError(f"{sms} SMs cannot be split into two groups of "
                         f"{granule}")
    top = granule * ((sms - granule) // granule)
    return min(top, max(granule, granule * int(n_c / granule + 0.5)))


def split_count(theta: float, sms: int, granule: int = GRANULE) -> int:
    """The c-core's SMs the split asks for at ``theta``: the reference's
    count, rounded to CUDA's granularity."""
    if not 0.0 < theta < 1.0:
        raise ValueError(f"theta must lie in (0, 1), got {theta}")
    return granular_count(reference_count(theta, sms), sms, granule)


# --------------------------------------------------------------------------
# the measured count
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Probe:
    """One c-core count the search tried: each core's chain time there
    (``t_c``, ``t_p``, any one unit), or None for both where the count's
    split was refused."""

    count: int
    t_c: float | None = None
    t_p: float | None = None

    @property
    def refused(self) -> bool:
        """True when the count could not be measured."""
        return self.t_c is None

    @property
    def bound(self) -> float:
        """The slot's bound at this count: the busier core's chain."""
        return max(self.t_c, self.t_p)


def balanced_count(measure: Callable[[int], tuple[float, float] | None],
                   start: int, sms: int,
                   granule: int = GRANULE) -> tuple[int, list[Probe]]:
    """The c-core count of ``sms`` with the lower measured slot bound of
    two, ``start`` and the count at which the two cores' SM-time measured
    at ``start`` (``n * t``) balances: ``(count, probes made)``, the
    start's first.

    ``measure(n)`` gives each core's chain time ``(t_c, t_p)`` with the
    c-core at ``n`` SMs, or None where the count's split is refused.  The
    balancing count, a multiple of ``granule`` leaving each core at least
    one, replaces the start only when its bound is lower: a tie, or a
    refused split there, keeps the start.  Returns the start without
    measuring further when the start itself is refused."""
    top = granule * ((sms - granule) // granule)
    if start % granule or not granule <= start <= top:
        raise ValueError(f"start {start} is no count of {sms} SMs in "
                         f"granules of {granule}")

    def take(n: int) -> Probe:
        got = measure(n)
        return Probe(n) if got is None else Probe(n, *got)

    first = take(start)
    if first.refused:
        return start, [first]
    work_c, work_p = start * first.t_c, (sms - start) * first.t_p
    if work_c + work_p <= 0:
        return start, [first]
    jump = granular_count(sms * work_c / (work_c + work_p), sms, granule)
    if jump == start:
        return start, [first]
    second = take(jump)
    won = not second.refused and second.bound < first.bound
    return (jump if won else start), [first, second]


# --------------------------------------------------------------------------
# libcuda
# --------------------------------------------------------------------------
_SIGNATURES = {
    "cuInit": [ctypes.c_uint],
    "cuDeviceGet": [ctypes.c_void_p, ctypes.c_int],
    "cuGetErrorName": [ctypes.c_int, ctypes.c_void_p],
    "cuDeviceGetDevResource": [ctypes.c_int, ctypes.c_void_p, ctypes.c_int],
    "cuDevSmResourceSplitByCount": [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_uint, ctypes.c_uint],
    "cuDevResourceGenerateDesc": [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_uint],
    "cuGreenCtxCreate": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                         ctypes.c_uint],
    "cuGreenCtxStreamCreate": [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_uint, ctypes.c_int],
}

_DRIVER: list = []


def driver():
    """``libcuda.so.1`` with the green-context entry points declared
    (loaded once).  Raises :class:`GreenContextError` if the library or a
    symbol is missing."""
    if _DRIVER:
        return _DRIVER[0]
    try:
        lib = ctypes.CDLL("libcuda.so.1")
    except OSError as err:
        raise GreenContextError(f"cannot load libcuda.so.1: {err}") from err
    for name, args in _SIGNATURES.items():
        try:
            fn = getattr(lib, name)
        except AttributeError:
            raise GreenContextError(
                f"the CUDA driver has no {name}: green contexts need a "
                f"driver of CUDA 12.5 or later") from None
        fn.argtypes = args
        fn.restype = ctypes.c_int
    _check(lib, lib.cuInit(0), "cuInit")
    _DRIVER.append(lib)
    return lib


def _check(lib, rc: int, what: str) -> None:
    """Raise :class:`GreenContextError` naming ``rc``'s ``CUresult``."""
    if rc == 0:
        return
    name = ctypes.c_char_p()
    if lib.cuGetErrorName(rc, ctypes.byref(name)) == 0 and name.value:
        label = name.value.decode()
    else:
        label = "unknown CUresult"
    raise GreenContextError(f"{what} failed: {label} ({rc})")


def _resource():
    return (ctypes.c_ubyte * RESOURCE_BYTES)()


def _sm_count(res) -> int:
    return ctypes.c_uint.from_buffer(res, SM_COUNT_OFFSET).value


# --------------------------------------------------------------------------
# the split
# --------------------------------------------------------------------------
@dataclasses.dataclass(eq=False)
class Partition:
    """One green context: its SMs and its streams (the core's stream, and
    the side stream graphs of the core are captured on)."""

    sms: int
    stream: torch.cuda.ExternalStream
    capture: torch.cuda.ExternalStream


class SmSplit:
    """Two green contexts on disjoint SMs of one card: ``parts["c"]`` of
    ``n_c`` SMs and ``parts["p"]`` of the rest (:func:`split_sms`)."""

    def __init__(self, device: torch.device, total: int, asked: int,
                 parts: dict[str, Partition]):
        self.device = device
        self.total = total          # the card's SMs
        self.asked = asked          # the c-core's count asked of the split
        self.parts = parts

    @property
    def theta(self) -> float:
        """The realised c-share of the card's SMs."""
        return self.parts["c"].sms / self.total

    def sms(self, core: str) -> int:
        """SMs of core ``"c"`` or ``"p"``."""
        return self.parts[core].sms


#: each split made, by (device ordinal, split flags, c-core SMs asked):
#: made once, kept for the life of the process
_SPLITS: dict[tuple[int, int, int], SmSplit] = {}
#: the SMs of the partition each split's stream runs on, by the stream's
#: handle (``cuda_stream``): a core's stream and its capture stream
_STREAM_SMS: dict[int, int] = {}


def stream_sms(handle: int) -> int | None:
    """The SMs of the partition whose stream has handle ``handle``, or
    None for a stream no split made (it runs on the whole card)."""
    return _STREAM_SMS.get(handle)


def _external_stream(handle: int, device: torch.device):
    return torch.cuda.ExternalStream(handle, device=device)


def _make_split(lib, dev: ctypes.c_int, whole, device: torch.device,
                total: int, asked: int, flags: int) -> SmSplit:
    """One ``cuDevSmResourceSplitByCount`` into a group of ``asked`` SMs
    and the remainder, a green context for each and two streams in it."""
    group, rest = _resource(), _resource()
    n_groups = ctypes.c_uint(1)
    _check(lib, lib.cuDevSmResourceSplitByCount(
        group, ctypes.byref(n_groups), whole, rest, flags, asked),
        f"cuDevSmResourceSplitByCount({asked} of {total} SMs)")
    if n_groups.value != 1:
        raise GreenContextError(f"cuDevSmResourceSplitByCount gave "
                                f"{n_groups.value} groups of {asked} SMs, "
                                f"asked for 1")
    parts = {}
    for core, res in (("c", group), ("p", rest)):
        desc = ctypes.c_void_p()
        _check(lib, lib.cuDevResourceGenerateDesc(ctypes.byref(desc), res,
                                                  1),
               "cuDevResourceGenerateDesc")
        ctx = ctypes.c_void_p()
        _check(lib, lib.cuGreenCtxCreate(ctypes.byref(ctx), desc, dev,
                                         CU_GREEN_CTX_DEFAULT_STREAM),
               "cuGreenCtxCreate")
        pair = []
        sms = _sm_count(res)
        for _ in range(2):
            s = ctypes.c_void_p()
            _check(lib, lib.cuGreenCtxStreamCreate(
                ctypes.byref(s), ctx, CU_STREAM_NON_BLOCKING, 0),
                "cuGreenCtxStreamCreate")
            pair.append(_external_stream(s.value, device))
            _STREAM_SMS[s.value] = sms
        parts[core] = Partition(sms=sms, stream=pair[0], capture=pair[1])
    return SmSplit(device, total, asked, parts)


def split_sms(device: torch.device, theta: float,
              flags: int = SPLIT_FLAGS) -> SmSplit:
    """Split ``device``'s SMs at ``theta``: a green context of
    :func:`split_count` SMs for the c-core and one of the remainder for the
    p-core, with two streams each; the split made before at that count, if
    there is one.  Raises :class:`GreenContextError` when CUDA cannot."""
    lib = driver()
    ordinal = device.index if device.index is not None \
        else torch.cuda.current_device()
    dev = ctypes.c_int()
    _check(lib, lib.cuDeviceGet(ctypes.byref(dev), ordinal), "cuDeviceGet")
    whole = _resource()
    _check(lib, lib.cuDeviceGetDevResource(dev, whole,
                                           CU_DEV_RESOURCE_TYPE_SM),
           "cuDeviceGetDevResource(SM)")
    total = _sm_count(whole)
    asked = split_count(theta, total)
    key = (dev.value, flags, asked)
    if key not in _SPLITS:
        _SPLITS[key] = _make_split(lib, dev, whole, device, total, asked,
                                   flags)
    return _SPLITS[key]


# --------------------------------------------------------------------------
# the SM probe (csrc/sm_probe.cu)
# --------------------------------------------------------------------------
#: cycles each probe block spins: about 0.1 ms, so a launch's blocks
#: spread over every SM the stream may use
PROBE_SPIN = 200_000


def probe_sms(device: torch.device, blocks: int, cluster: int = 1,
              spin: int = PROBE_SPIN) -> torch.Tensor:
    """Launch the SM probe on the current stream of ``device``: ``blocks``
    blocks (one an SM at a time) in clusters of ``cluster``; returns the
    int32 tensor of the SM each block ran on, written when the stream gets
    there."""
    from repro_torch.kernels.util import launch
    out = torch.full((blocks,), -1, dtype=torch.int32, device=device)
    launch("repro_sm_probe", device, out, blocks, cluster, spin)
    return out


def probe_set(device: torch.device, stream, blocks: int,
              capture=None, cluster: int = 1) -> list[int]:
    """The sorted SMs that ``blocks`` probe blocks (in clusters of
    ``cluster``) ran on: launched on ``stream``, or, given a ``capture``
    stream, captured there into a CUDA graph that is replayed on
    ``stream``.  Waits on ``stream`` (``torch.cuda.synchronize()`` does not
    wait for a partition's stream); raises if a block wrote nothing."""
    from repro_torch.kernels.util import capture_graph
    if capture is None:
        with torch.cuda.stream(stream):
            out = probe_sms(device, blocks, cluster)
    else:
        graph, out = capture_graph(
            lambda: probe_sms(device, blocks, cluster), stream=capture)
        with torch.cuda.stream(stream):
            graph.replay()
    stream.synchronize()
    ids = out.cpu().tolist()
    if min(ids) < 0:
        raise RuntimeError("the SM probe: a block wrote nothing")
    return sorted(set(ids))


def max_active_clusters(device: torch.device, cluster: int) -> int:
    """Clusters of ``cluster`` probe blocks (one an SM) that the SMs of the
    current stream of ``device`` hold at once
    (``cudaOccupancyMaxActiveClusters``)."""
    from repro_torch.kernels.util import kernel_library
    lib = kernel_library()
    count = ctypes.c_int(0)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = lib.repro_sm_probe_clusters(cluster, ctypes.addressof(count),
                                         stream)
    if rc != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters({cluster}) "
                           f"failed: CUDA error {rc} "
                           f"({lib.repro_error_string(rc).decode()})")
    return count.value
