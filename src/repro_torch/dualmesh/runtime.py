"""Dual-core LM runtime: N-stream continuous batching on one card.

Port of ``repro/dualmesh/runtime.py``.  Chunked prefills run on the c-core
and fused decode groups on the p-core; on a card the two cores are two
CUDA streams (:func:`~repro_torch.dualmesh.partition.split_streams`), so a
prefill and a decode group queued in the same scheduler slot run at once,
the host only enqueueing.  On the CPU both cores alias one queue.  The
scheduler loop lives in :class:`repro_torch.serving.lm.DualMeshEngine`;
``DualMeshRunner.serve`` submits everything to one and drains it.

Cross-stream rules.  A stream's prefill records a ready event on the
c-core; the decode group that fuses it waits on that event on the p-core
and marks every tensor it takes over (tokens, cache) with
``record_stream``, so the allocator never reuses their memory while the
p-core may still read them.  Each decode group records its own ready
event after its last step or eviction; completions wait on that one
event, never on the whole device.

The KV cache is written in place (no copy per step): prefill writes a
stream's cache on the c-core, and from the fuse on only the p-core writes
it, whether the group reuses it (one member) or concatenates the members'
caches into a new one.  No cache is written by both streams.

Streams fuse only at equal cache position, because ``DecodeCache.pos`` is
one host int per group; equal-length prompts always align.
``run_two_streams`` is the N=2, group_size=1 case, the paper's two-image
interleave.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.dualmesh.cost import CardModel
from repro_torch.dualmesh.partition import DualStreams
from repro_torch.dualmesh.schedule import plan_admission
from repro_torch.lm.config import ArchConfig
from repro_torch.lm.model import (DecodeCache, check_supported, decode_step,
                                  init_cache)

Rows = list[tuple[int, int]]     # [row0, row1) ranges of a fused batch


def _concat_caches(caches: Sequence[DecodeCache]) -> DecodeCache:
    """Stack position-aligned caches along the batch axis (the first one
    itself when there is one)."""
    first = caches[0]
    if len(caches) == 1:
        return first
    if any(c.pos != first.pos for c in caches):
        raise ValueError("only position-aligned caches fuse")
    return DecodeCache(torch.cat([c.kv_k for c in caches], dim=1),
                       torch.cat([c.kv_v for c in caches], dim=1),
                       first.pos)


def _take_rows(cache: DecodeCache, rows: Rows) -> DecodeCache:
    """A new cache holding the given row ranges, in order."""
    return DecodeCache(torch.cat([cache.kv_k[:, a:b] for a, b in rows], 1),
                       torch.cat([cache.kv_v[:, a:b] for a, b in rows], 1),
                       cache.pos)


def _rows_of(t: torch.Tensor, rows: Rows) -> torch.Tensor:
    return torch.cat([t[a:b] for a, b in rows], 0)


@dataclasses.dataclass
class StreamState:
    """One admitted request stream."""

    rid: int
    tokens: torch.Tensor       # running token buffer (B, t)
    cache: DecodeCache
    gen_target: int            # decode steps still owed after prefill
    done_prefill: bool = False
    ready: torch.cuda.Event | None = None   # c-core: tokens/cache written


@dataclasses.dataclass
class _Member:
    """A stream's slice of a fused decode group."""

    rid: int
    row0: int                  # first row in the fused batch
    batch: int
    prefix: torch.Tensor       # tokens up to (and incl.) the prefill emit
    remaining: int


@dataclasses.dataclass
class DecodeGroup:
    """Several position-aligned streams decoding as one fused batch."""

    members: list[_Member]
    last_tok: torch.Tensor     # (B_total, 1)
    cache: DecodeCache
    history: list[torch.Tensor] = dataclasses.field(default_factory=list)
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


class DualMeshRunner:
    """Runs chunked prefills on the c-core and fused decode batches on the
    p-core of one device, N request streams interleaved.

    ``params`` is the stacked parameter tree on the cores' device, as
    ``params_from_numpy`` gives it; the two cores read it in place.
    ``trace``
    gets one ``(kind, core, host seconds)`` entry per stage, the host's
    enqueue time of the stage; :meth:`trace_stream_ms` gives the time
    each took on its core's stream (CUDA only).
    """

    def __init__(self, cfg: ArchConfig, params: dict, dual: DualStreams,
                 max_len: int = 256):
        check_supported(cfg)
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
    # fused decode groups (continuous batching on the p-core)
    # ------------------------------------------------------------------
    def _fuse(self, streams: list[StreamState]) -> DecodeGroup:
        """Fuse prefilled streams into one decode group on the p-core."""
        p = self.dual.stream("p")
        members, row = [], 0
        with self._on("p"):
            for s in streams:
                if p is not None:
                    if s.ready is not None:
                        p.wait_event(s.ready)
                    for t in (s.tokens, s.cache.kv_k, s.cache.kv_v):
                        t.record_stream(p)
                b = s.tokens.shape[0]
                members.append(_Member(rid=s.rid, row0=row, batch=b,
                                       prefix=s.tokens,
                                       remaining=s.gen_target))
                row += b
            last = torch.cat([s.tokens[:, -1:] for s in streams], 0)
            cache = _concat_caches([s.cache for s in streams])
        return DecodeGroup(members=members, last_tok=last, cache=cache)

    def _decode_group(self, g: DecodeGroup, steps: int) -> None:
        """``steps`` fused decode steps of group ``g`` on the p-core."""
        t0 = time.perf_counter()
        with self._on("p"):
            start = self._event("p")
            tok, cache = g.last_tok, g.cache
            for _ in range(steps):
                logits, cache = decode_step(self.params, self.cfg, tok,
                                            cache)
                tok = torch.argmax(logits[:, -1, :self.cfg.vocab],
                                   dim=-1)[:, None]
                g.history.append(tok)
            g.last_tok, g.cache = tok, cache
            g.ready = self._event("p")
        for m in g.members:
            m.remaining -= steps
        self._log("decode", "p", t0, start)

    def _evict(self, g: DecodeGroup, outputs: dict) -> DecodeGroup | None:
        """Slice finished members' rows out of the fused batch.  Each
        finished member's ``outputs[rid]`` is ``(tokens, ready event)``;
        returns None once the group is empty."""
        done = [m for m in g.members if m.remaining <= 0]
        if not done:
            return g
        finished = {}
        with self._on("p"):
            for m in done:
                cols = [h[m.row0:m.row0 + m.batch] for h in g.history]
                finished[m.rid] = (torch.cat([m.prefix] + cols, 1) if cols
                                   else m.prefix)
            alive = [m for m in g.members if m.remaining > 0]
            if alive:
                rows = [(m.row0, m.row0 + m.batch) for m in alive]
                g.cache = _take_rows(g.cache, rows)
                g.last_tok = _rows_of(g.last_tok, rows)
                g.history = [_rows_of(h, rows) for h in g.history]
            g.ready = self._event("p")
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
