"""Streaming LM engine: the dual-core serve loop behind the engine API.

Port of ``repro/serving/lm.py``.  :class:`DualMeshEngine` owns the policy,
the :class:`~repro_torch.dualmesh.runtime.DualMeshRunner` the mechanics
(chunked prefill on the c-core, fused decode groups on the p-core,
eviction) and :class:`~repro_torch.serving.api.EngineBase` the request
lifecycle.  One ``step`` is one scheduler slot:

  1. advance every active decode group on the p-core until its earliest
     member reaches its generation target, and retire the members that
     did;
  2. admit one queued request and run its chunked prefill on the c-core
     (the paper's stagger: the prefill runs beside the decode queued just
     before);
  3. fuse position-aligned prefilled streams into decode groups once
     ``group_size`` of them are ready (or the queue has drained);
  4. only then wait for the outputs finished in the slot and file their
     completions: no wait inside the dispatch loops, so the host queues
     the whole slot before it blocks.

``step`` has no shed sweep yet.  The fleet-facing surface of the
reference engine (shedding, ``retune``, ``next_dispatch_cycles``,
``next_core``, and its ``quantum``, ``policy`` and ``max_in_flight``
options) comes with LM members of the fleet (ROADMAP queue 1 item 6.3).
"""
from __future__ import annotations

import time
from typing import TYPE_CHECKING

from repro_torch.serving.api import Completion, EngineBase, Metrics

if TYPE_CHECKING:
    from repro_torch.dualmesh.runtime import DualMeshRunner


class DualMeshEngine(EngineBase):
    """Continuous-batching LM serving over a :class:`DualMeshRunner`.

    group_size      decode fusion width; None fuses every position-aligned
                    ready stream once the queue drains (callers wanting the
                    makespan-aware width pass
                    ``runner.planned_group_size(...)``)
    prefill_chunk   chunked-prefill slice in tokens (None = whole prompt)
    max_queue       bounded request queue; submit raises QueueFull beyond it
    """

    def __init__(self, runner: "DualMeshRunner", *,
                 group_size: int | None = None,
                 prefill_chunk: int | None = None,
                 max_queue: int | None = None):
        super().__init__(max_queue=max_queue)
        self.runner = runner
        self.group_size = None if group_size is None else max(1, group_size)
        self.prefill_chunk = prefill_chunk
        self._ready: list = []                 # prefilled StreamStates
        self._groups: list = []                # active DecodeGroups
        self._trace_start = len(runner.trace)
        self.prefill_tokens = 0
        self.decode_tokens = 0
        self.fused_sizes: list[int] = []

    # ------------------------------------------------------------------
    @property
    def in_flight(self) -> int:
        """Requests currently prefilling or decoding."""
        return len(self._ready) + sum(len(g.members) for g in self._groups)

    @property
    def has_work(self) -> bool:
        """True while any queued or in-flight work remains."""
        return bool(self._pending or self._ready or self._groups)

    # ------------------------------------------------------------------
    def step(self) -> list[Completion]:
        """One scheduler slot (see module docstring)."""
        self._start_clock()
        r = self.runner
        done: list[tuple] = []          # (rid, tokens, ready event)
        # 1. p-core: advance active decode groups (queued, not waited on)
        for g in list(self._groups):
            q = min(m.remaining for m in g.members)
            if q > 0:
                r._decode_group(g, q)
                self.decode_tokens += q * g.batch
            finished: dict = {}
            if r._evict(g, finished) is None:
                self._groups.remove(g)
            done.extend((rid, out, ev) for rid, (out, ev) in finished.items())
        # 2. c-core: admit one queued request, chunked prefill it
        popped = self._pop_admission()
        if popped is not None:
            req, _ticket = popped
            self._metrics[req.rid].started_at = time.perf_counter()
            st = r.new_stream(req.payload, int(req.gen_steps), rid=req.rid)
            want = st.gen_target
            plen = st.tokens.shape[1]
            self.prefill_tokens += st.tokens.numel()
            st = r.run_prefill(st, self.prefill_chunk)
            if want <= 0:               # prefill-only request: no emit
                done.append((req.rid, st.tokens[:, :plen], st.ready))
            else:
                self.decode_tokens += st.tokens.shape[0]  # the prefill emit
                st.gen_target -= 1
                if st.gen_target <= 0:
                    done.append((req.rid, st.tokens, st.ready))
                else:
                    self._ready.append(st)
        # 3. fuse position-aligned ready streams into decode groups once
        #    group_size are waiting, or the queue has drained
        buckets: dict[tuple, list] = {}
        for st in self._ready:
            buckets.setdefault((st.tokens.shape[1],), []).append(st)
        self._ready = []
        for bucket in buckets.values():
            while (self.group_size is not None
                   and len(bucket) >= self.group_size) \
                    or (bucket and not self._pending):
                width = (self.group_size if self.group_size is not None
                         else len(bucket))
                take, bucket = bucket[:width], bucket[width:]
                self.fused_sizes.append(len(take))
                self._groups.append(r._fuse(take))
            self._ready.extend(bucket)
        # 4. wait for this slot's finished outputs only now, after every
        #    launch of the slot is queued
        return [self._finish(rid, out, ev) for rid, out, ev in done]

    # ------------------------------------------------------------------
    def _extra_stats(self, metrics: Metrics) -> dict:
        total = self.prefill_tokens + self.decode_tokens
        wall = metrics.wall_s
        return {"engine": "dualmesh",
                "n_streams": len(self._order),
                "group_size": self.group_size,
                "fused_sizes": list(self.fused_sizes),
                "prefill_tokens": self.prefill_tokens,
                "decode_tokens": self.decode_tokens,
                "total_tokens": total,
                "tokens_per_s": total / wall if wall else float("inf")}

    def _trace_snapshot(self) -> list:
        return self.runner.trace[self._trace_start:]
