"""Dual-core LM runtime: N-stream continuous batching on one card.

Port of ``repro/dualmesh/runtime.py``.  Chunked prefills run on the c-core
and fused decode groups on the p-core; on a card the two cores are two
green contexts on disjoint SMs, a stream each
(:func:`~repro_torch.dualmesh.partition.split_streams`), so a prefill and
a decode group queued in the same scheduler slot run at once on their own
SMs, the host only enqueueing.  On the CPU both cores alias one queue.  The
scheduler loop lives in :class:`repro_torch.serving.lm.DualMeshEngine`;
``DualMeshRunner.serve`` submits everything to one and drains it.

Cross-stream rules.  A stream's prefill records a ready event on the
c-core; the decode group that fuses it waits on that event on the p-core
and marks every tensor it takes over (tokens, cache) with
``record_stream``, so the allocator never reuses their memory while the
p-core may still read them.  Each decode group records its own ready
event after its last step or eviction; completions wait on that one
event, never on the whole device.

The cache is written in place (no copy per step): prefill writes a
stream's cache on the c-core; the fuse copies the members' caches and
tokens into a :class:`DecodeLane` on the p-core, and from then on only the
p-core writes it.  No buffer is written by both streams.  A lane holds
every row field of the family's cache (``lm/model.py``'s ``ROW_FIELDS``:
the KV cache, the SSM states and convolution tails, Zamba2's shared
block's KV caches), and the fuse and the eviction move each along its
batch axis, as the reference's ``_concat_caches`` and ``_take_rows`` do.

Compiled decode (``jit_groups``, the reference's ``jax.jit`` of
``decode_fn``): a decode group runs on a lane, the static buffers of its
key (rows, cache capacity): the cache, each row's tokens (prompt, then
every generated token, at its position) and the device position.  One
fused step (embed, every layer, the final norm, the LM head, the argmax
written into the token buffer, the position advanced) reads and writes
only those, at the same shapes at every position (``lm/model.py``'s
shape-static decode; an SSM layer steps its state in place), so on the
card it is captured once per lane into a
CUDA graph, on the p-core's capture stream so that its kernels run on
the p-core's SMs, and replayed once a step.  Lanes are pooled per key: the fuse
and the eviction copy into a free lane of their width (a new capture when
every lane of the key is held) and hand the old one back behind the
p-core's event, so two live groups never share buffers.  The first lane of
a key is preceded by one eager step.  Without ``jit_groups``, or on the
CPU, the same step runs eagerly on the same lanes.  Prefill stays eager.

Streams fuse only at equal cache position, because a group's position is
one host int (and one device scalar); equal-length prompts always align.
``run_two_streams`` is the N=2, group_size=1 case, the paper's two-image
interleave.  An encoder-decoder model is refused: serving has no encoder
input for its cache (the reference's ``init_cache`` asserts on it).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.dualcore.runtime import LanePool
from repro_torch.dualmesh.cost import CardModel
from repro_torch.dualmesh.partition import DualStreams
from repro_torch.dualmesh.schedule import plan_admission
from repro_torch.kernels.util import CountedGraph, capture_graph
from repro_torch.lm.config import ArchConfig
from repro_torch.lm.model import (DecodeCache, cache_rows, check_supported,
                                  decode_step, init_cache, rows_cache)


@dataclasses.dataclass
class StreamState:
    """One admitted request stream."""

    rid: int
    tokens: torch.Tensor       # running token buffer (B, t)
    cache: DecodeCache
    gen_target: int            # decode steps still owed after prefill
    done_prefill: bool = False
    ready: torch.cuda.Event | None = None   # c-core: tokens/cache written


@dataclasses.dataclass(eq=False)
class DecodeLane:
    """The static buffers of a fused decode group of ``key`` = (rows,
    cache capacity), and the graph of one step over them (on the card)."""

    key: tuple[int, int]
    cache: dict[str, torch.Tensor]   # the cache's row fields, by name
    seq: torch.Tensor          # (rows, capacity + 1) int64: every token
    pos: torch.Tensor          # () int32: positions cached
    logits: torch.Tensor | None = None   # the last step's (rows, 1, V)
    graph: CountedGraph | None = None
    nbytes: int = 0            # device memory of buffers and capture
    free_after: torch.cuda.Event | None = None  # last user's final event


@dataclasses.dataclass
class _Member:
    """A stream's slice of a fused decode group."""

    rid: int
    row0: int                  # first row in the fused batch
    batch: int
    remaining: int


@dataclasses.dataclass
class DecodeGroup:
    """Several position-aligned streams decoding as one fused batch."""

    members: list[_Member]
    lane: DecodeLane
    pos: int                   # positions cached (the lane's, on the host)
    ready: torch.cuda.Event | None = None   # p-core: last work written

    @property
    def batch(self) -> int:
        """Rows of the fused batch."""
        return sum(m.batch for m in self.members)


@dataclasses.dataclass
class ServeResult:
    """What :meth:`DualMeshRunner.serve` returns."""

    outputs: list[torch.Tensor]   # per request, in submission order
    trace: list[tuple[str, str, float]]
    stats: dict


def check_servable(cfg: ArchConfig) -> None:
    """Raise unless the runtime can serve ``cfg``: ``check_supported``'s
    architectures but the encoder-decoder ones, whose cache needs the
    encoder's output, which a serving request does not carry."""
    check_supported(cfg)
    if cfg.encoder_decoder:
        raise ValueError(f"{cfg.name}: an encoder-decoder model is not "
                         f"served: serving has no encoder input for its "
                         f"cross-attention cache")


class DualMeshRunner:
    """Runs chunked prefills on the c-core and fused decode batches on the
    p-core of one device, N request streams interleaved.

    ``params`` is the stacked parameter tree on the cores' device, as
    ``params_from_numpy`` gives it; the two cores read it in place.
    ``trace``
    gets one ``(kind, core, host seconds)`` entry per stage, the host's
    enqueue time of the stage; :meth:`trace_stream_ms` gives the time
    each took on its core's stream (CUDA only).  ``jit_groups`` replays
    each decode step as one CUDA graph on the card (module docstring);
    ``lanes`` is the :class:`~repro_torch.dualcore.runtime.LanePool` of
    decode lanes and ``capture_s`` the host seconds spent capturing.
    """

    def __init__(self, cfg: ArchConfig, params: dict, dual: DualStreams,
                 max_len: int = 256, jit_groups: bool = True):
        check_servable(cfg)
        self.cfg = cfg
        self.dual = dual
        self.device = dual.device
        self.max_len = max_len
        if params["embed"].device != self.device:
            raise ValueError(f"params are on {params['embed'].device}, the "
                             f"cores on {self.device}")
        self.params = params
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)   # params visible to both
        self.trace: list[tuple[str, str, float]] = []
        self._trace_events: list[tuple | None] = []
        self.jit_groups = jit_groups
        self._compiled = jit_groups and self.device.type == "cuda"
        self.lanes = LanePool(self._new_lane)
        self.capture_s = 0.0

    # ------------------------------------------------------------------
    def _on(self, core: str):
        """Run on ``core``'s stream (a no-op on the CPU)."""
        s = self.dual.stream(core)
        return torch.cuda.stream(s) if s is not None \
            else contextlib.nullcontext()

    def _event(self, core: str) -> torch.cuda.Event | None:
        s = self.dual.stream(core)
        if s is None:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(s)
        return ev

    def _log(self, kind: str, core: str, t0: float, start) -> None:
        self.trace.append((kind, core, time.perf_counter() - t0))
        self._trace_events.append(
            None if start is None else (start, self._event(core)))

    def trace_stream_ms(self) -> list[float | None]:
        """Ms between each trace entry's start and end events on its
        core's stream: the stage's device time plus any gaps in which the
        stream waited for the host.  Waits for the events; None on the
        CPU."""
        out = []
        for ev in self._trace_events:
            if ev is None:
                out.append(None)
            else:
                ev[1].synchronize()
                out.append(ev[0].elapsed_time(ev[1]))
        return out

    # ------------------------------------------------------------------
    # stream lifecycle
    # ------------------------------------------------------------------
    def new_stream(self, prompt: torch.Tensor, gen_steps: int = 0,
                   rid: int = 0) -> StreamState:
        """Admit ``prompt`` (B, P) token ids: its buffer and an empty cache
        on the c-core.  The c-core first waits for the caller's stream, so
        a prompt made there is complete."""
        c = self.dual.stream("c")
        if c is not None:
            c.wait_stream(torch.cuda.current_stream(self.device))
        with self._on("c"):
            tokens = prompt.to(self.device)
            if c is not None:
                tokens.record_stream(c)
            cache = init_cache(self.cfg, tokens.shape[0], self.max_len,
                               self.device)
        return StreamState(rid=rid, tokens=tokens, cache=cache,
                           gen_target=gen_steps)

    def run_prefill(self, st: StreamState,
                    chunk: int | None = None) -> StreamState:
        """Chunked prefill on the c-core: the prompt is processed in
        ``chunk``-token slices (the Alg.1 split knob); the final slice's
        logits emit the first generated token."""
        t0 = time.perf_counter()
        with self._on("c"):
            start = self._event("c")
            tokens, cache = st.tokens, st.cache
            plen = tokens.shape[1]
            step = chunk if chunk and 0 < chunk < plen else plen
            logits = None
            for lo in range(0, plen, step):
                logits, cache = decode_step(self.params, self.cfg,
                                            tokens[:, lo:lo + step], cache,
                                            last_only=True)
            nxt = torch.argmax(logits[:, -1, :self.cfg.vocab], dim=-1)
            out = StreamState(rid=st.rid,
                              tokens=torch.cat([tokens, nxt[:, None]], 1),
                              cache=cache, gen_target=st.gen_target,
                              done_prefill=True)
            out.ready = self._event("c")
        self._log("prefill", "c", t0, start)
        return out

    # ------------------------------------------------------------------
    # decode lanes
    # ------------------------------------------------------------------
    def _new_lane(self, key: tuple[int, int]) -> DecodeLane:
        """Buffers for a decode group of ``key`` = (rows, capacity), made
        on the current stream (the p-core's); on the card, also the graph
        of one step over them, after one eager step if the key is new."""
        rows, cap = key
        cfg, dev = self.cfg, self.device
        lane = DecodeLane(
            key=key, cache=cache_rows(init_cache(cfg, rows, cap, dev)),
            seq=torch.zeros((rows, cap + 1), dtype=torch.int64, device=dev),
            pos=torch.zeros((), dtype=torch.int32, device=dev))
        lane.nbytes = sum(t.numel() * t.element_size()
                          for t in (*lane.cache.values(), lane.seq, lane.pos))
        if not self._compiled:
            return lane
        if not self.lanes.lanes.get(key):
            self._step(lane)           # warm-up; the fuse overwrites it
        t0 = time.perf_counter()
        reserved = torch.cuda.memory_reserved(dev)
        try:
            lane.graph, lane.logits = capture_graph(
                lambda: self._step(lane),
                stream=self.dual.cores.capture_stream("p"))
        except Exception as err:
            raise RuntimeError(f"{cfg.name}: capturing the decode step of "
                               f"{rows} rows at capacity {cap} failed: "
                               f"{err}") from err
        lane.nbytes += torch.cuda.memory_reserved(dev) - reserved
        self.capture_s += time.perf_counter() - t0
        return lane

    def _step(self, lane: DecodeLane) -> torch.Tensor:
        """One fused decode step on ``lane``: the token at the lane's
        position through the model, its argmax written at the next
        position, the position advanced.  Returns the logits.  Reads the
        position only on the card (the graph's body); bounds are the
        caller's to check, on the host."""
        at = lane.pos.reshape(1).long()
        tok = lane.seq.index_select(1, at)
        logits, cache = decode_step(self.params, self.cfg, tok,
                                    rows_cache(lane.cache, 0, lane.pos))
        nxt = torch.argmax(logits[:, -1, :self.cfg.vocab], dim=-1)
        lane.seq.index_copy_(1, cache.pos_dev.reshape(1).long(),
                             nxt[:, None])
        lane.pos.copy_(cache.pos_dev)
        return logits

    def _take_lane(self, rows: int) -> DecodeLane:
        """A free lane of ``rows`` rows on the p-core, behind the event of
        its previous group's last work."""
        lane = self.lanes.acquire((rows, self.max_len))
        if lane.free_after is not None:
            torch.cuda.current_stream(self.device).wait_event(
                lane.free_after)
        return lane

    # ------------------------------------------------------------------
    # fused decode groups (continuous batching on the p-core)
    # ------------------------------------------------------------------
    def _fuse(self, streams: list[StreamState]) -> DecodeGroup:
        """Fuse prefilled streams into one decode group on the p-core:
        their caches and tokens are copied into a lane of their width."""
        pos = streams[0].cache.pos
        if any(s.cache.pos != pos for s in streams):
            raise ValueError("only position-aligned caches fuse")
        p = self.dual.stream("p")
        members, row = [], 0
        with self._on("p"):
            for s in streams:
                if p is not None:
                    if s.ready is not None:
                        p.wait_event(s.ready)
                    for t in (s.tokens, *cache_rows(s.cache).values()):
                        t.record_stream(p)
                b = s.tokens.shape[0]
                members.append(_Member(rid=s.rid, row0=row, batch=b,
                                       remaining=s.gen_target))
                row += b
            lane = self._take_lane(row)
            for f, buf in lane.cache.items():
                torch.cat([getattr(s.cache, f) for s in streams], 1, out=buf)
            for m, s in zip(members, streams):
                lane.seq[m.row0:m.row0 + m.batch, :pos + 1].copy_(s.tokens)
            lane.pos.fill_(pos)
        return DecodeGroup(members=members, lane=lane, pos=pos)

    def _decode_group(self, g: DecodeGroup, steps: int) -> None:
        """``steps`` fused decode steps of group ``g`` on the p-core: its
        lane's graph replayed ``steps`` times, or the step run eagerly."""
        if g.pos + steps > self.max_len:
            raise ValueError(f"decode: {g.pos} cached + {steps} new "
                             f"positions exceed the cache's {self.max_len}")
        t0 = time.perf_counter()
        lane = g.lane
        with self._on("p"):
            start = self._event("p")
            for _ in range(steps):
                if lane.graph is not None:
                    lane.graph.replay()
                else:
                    lane.logits = self._step(lane)
            g.pos += steps
            g.ready = self._event("p")
        for m in g.members:
            m.remaining -= steps
        self._log("decode", "p", t0, start)

    def _evict(self, g: DecodeGroup, outputs: dict) -> DecodeGroup | None:
        """Take finished members' rows out of the fused batch: each
        finished member's ``outputs[rid]`` is ``(tokens, ready event)``;
        the other members' rows are copied into a lane of their width.
        Returns None once the group is empty."""
        done = [m for m in g.members if m.remaining <= 0]
        if not done:
            return g
        finished = {}
        old = g.lane
        end = g.pos + 1
        with self._on("p"):
            for m in done:
                finished[m.rid] = old.seq[m.row0:m.row0 + m.batch,
                                          :end].clone()
            alive = [m for m in g.members if m.remaining > 0]
            if alive:
                rows = [(m.row0, m.row0 + m.batch) for m in alive]
                new = self._take_lane(sum(b - a for a, b in rows))
                for f, buf in new.cache.items():
                    torch.cat([old.cache[f][:, a:b] for a, b in rows], 1,
                              out=buf)
                new.seq[:, :end].copy_(torch.cat(
                    [old.seq[a:b, :end] for a, b in rows], 0))
                new.pos.copy_(old.pos)
                g.lane = new
            g.ready = self._event("p")
        self.lanes.retire(old, g.ready)
        for rid, out in finished.items():
            outputs[rid] = (out, g.ready)
        if not alive:
            return None
        row = 0
        for m in alive:
            m.row0 = row
            row += m.batch
        g.members = alive
        return g

    # ------------------------------------------------------------------
    # the scheduler loop: a shim over the streaming engine
    # ------------------------------------------------------------------
    def serve(self, prompts: Sequence[torch.Tensor],
              gen_steps: int | Sequence[int] = 8,
              group_size: int | None = None,
              prefill_chunk: int | None = None,
              hw: CardModel | None = None) -> ServeResult:
        """Run a ready request list to completion through a fresh
        :class:`repro_torch.serving.lm.DualMeshEngine`.

        gen_steps      total generated tokens per request (the prefill
                       emits the first; int or one per request)
        group_size     decode fusion width; default the makespan-aware
                       plan_admission choice (homogeneous queues) else
                       everything position-aligned
        prefill_chunk  chunked-prefill slice (None = whole prompt)
        """
        from repro_torch.serving.api import Request
        from repro_torch.serving.lm import DualMeshEngine

        n = len(prompts)
        gens = ([int(gen_steps)] * n if isinstance(gen_steps, int)
                else list(gen_steps))
        if len(gens) != n:
            raise ValueError(f"{n} prompts but {len(gens)} gen_steps")
        if group_size is None:
            group_size = self.planned_group_size(prompts, gens, hw)
        engine = DualMeshEngine(self, group_size=max(1, group_size),
                                prefill_chunk=prefill_chunk)
        for p, g in zip(prompts, gens):
            engine.submit(Request(payload=p, gen_steps=g))
        res = engine.drain()
        return ServeResult(outputs=res.outputs, trace=res.trace,
                           stats=res.stats)

    def planned_group_size(self, prompts, gens,
                           hw: CardModel | None = None) -> int:
        """Makespan-aware default fusion width (homogeneous queues only;
        mixed shapes fuse everything position-aligned)."""
        shapes = {tuple(p.shape) for p in prompts}
        if len(shapes) != 1 or len(set(gens)) != 1:
            return len(prompts)
        b, plen = next(iter(shapes))
        plan = plan_admission(self.cfg, self.dual, hw or CardModel(),
                              b, plen, gens[0], len(prompts))
        return plan.group_size

    def run_two_streams(self, prompt_a: torch.Tensor,
                        prompt_b: torch.Tensor, gen_steps: int = 8):
        """Fig.4b: A prefills (c) alone; then A decodes (p) while B
        prefills (c); then B decodes (p): ``serve`` with group_size=1.
        ``gen_steps`` counts post-prefill decode steps, so each output has
        prompt+1+gen tokens."""
        res = self.serve([prompt_a, prompt_b], gen_steps=gen_steps + 1,
                         group_size=1)
        return res.outputs[0], res.outputs[1], res.trace


def random_prompts(cfg: ArchConfig, n: int, batch: int, prompt_len: int,
                   seed: int = 1,
                   device: str | torch.device = "cpu") -> list[torch.Tensor]:
    """``n`` seeded (batch, prompt_len) token prompts below ``cfg.vocab``,
    made with numpy and placed on ``device``."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(0, cfg.vocab, (batch, prompt_len),
                                          dtype=np.int64)).to(device)
            for _ in range(n)]
