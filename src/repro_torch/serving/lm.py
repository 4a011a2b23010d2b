"""Streaming LM engine: the dual-core serve loop behind the engine API.

Port of ``repro/serving/lm.py``.  :class:`DualMeshEngine` owns the policy,
the :class:`~repro_torch.dualmesh.runtime.DualMeshRunner` the mechanics
(chunked prefill on the c-core, fused decode groups on the p-core,
eviction) and :class:`~repro_torch.serving.api.EngineBase` the request
lifecycle.  One ``step`` is one scheduler slot:

  0. shed queued requests past their deadline (under a ``ShedPolicy``;
     the fleet executor sweeps at its RUN instead, on its slot clock);
  1. advance every active decode group on the p-core by a quantum of
     fused steps (``quantum=None``: until its earliest member reaches its
     generation target), and retire the members that did;
  2. ask the :class:`~repro_torch.serving.api.AdmissionPolicy` how many
     queued requests to admit (default one a slot, the paper's stagger:
     the prefill runs beside the decode queued just before) and run
     their chunked prefills on the c-core;
  3. fuse position-aligned prefilled streams into decode groups once
     ``group_size`` of them are ready, or once no further prefill can
     arrive now (the queue drained, or admission stalled at
     ``max_in_flight``);
  4. only then wait for the outputs finished in the slot and file their
     completions: no wait inside the dispatch loops, so the host queues
     the whole slot before it blocks.  A shed completion has no output
     and nothing to wait for.

The fleet-facing surface: ``next_dispatch_cycles`` and ``next_core``
(which core the next step loads more), and ``retune`` (the SET_PARAM
hook a fleet controller drives: ``group_size``, ``quantum`` and
``prefill_chunk`` change for work scheduled after the call; a live
decode group keeps its width and its lane).
"""
from __future__ import annotations

import time
from typing import TYPE_CHECKING

from repro_torch.serving.api import (AdmissionPolicy, Completion,
                                     EngineBase, FixedRateAdmission, Metrics)

if TYPE_CHECKING:
    from repro_torch.dualmesh.runtime import DualMeshRunner


class DualMeshEngine(EngineBase):
    """Continuous-batching LM serving over a :class:`DualMeshRunner`.

    group_size      decode fusion width; None fuses every position-aligned
                    ready stream once the queue drains (callers wanting the
                    makespan-aware width pass
                    ``runner.planned_group_size(...)``)
    prefill_chunk   chunked-prefill slice in tokens (None = whole prompt)
    quantum         fused decode steps per slot (None = run a group until
                    its earliest member finishes)
    policy          admissions per slot (default one per slot, the stagger)
    max_queue       bounded request queue; submit raises QueueFull beyond it
    max_in_flight   cap on admitted-but-unfinished streams (None = no cap)
    """

    def __init__(self, runner: "DualMeshRunner", *,
                 group_size: int | None = None,
                 prefill_chunk: int | None = None,
                 quantum: int | None = None,
                 policy: AdmissionPolicy | None = None,
                 max_queue: int | None = None,
                 max_in_flight: int | None = None):
        super().__init__(max_queue=max_queue)
        self.runner = runner
        self.group_size = None if group_size is None else max(1, group_size)
        self.prefill_chunk = prefill_chunk
        # a 0-quantum would never progress a decode group
        self.quantum = None if quantum is None else max(1, quantum)
        self.policy = policy or FixedRateAdmission(1)
        self.max_in_flight = max_in_flight
        self._ready: list = []                 # prefilled StreamStates
        self._groups: list = []                # active DecodeGroups
        self._trace_start = len(runner.trace)
        self.prefill_tokens = 0
        self.decode_tokens = 0
        self.fused_sizes: list[int] = []
        self.retunes: list[tuple[int, dict]] = []   # mid-run knob changes

    # ------------------------------------------------------------------
    @property
    def in_flight(self) -> int:
        """Requests currently prefilling or decoding."""
        return len(self._ready) + sum(len(g.members) for g in self._groups)

    @property
    def has_work(self) -> bool:
        """True while any queued or in-flight work remains."""
        return bool(self._pending or self._ready or self._groups)

    def next_dispatch_cycles(self) -> tuple[float, float]:
        """Predicted (c-core, p-core) work of the next ``step``, in tokens
        (the LM analog of the CNN engine's cycle estimate): queued prompts
        prefill on the c-core, active decode groups advance on the p-core.
        Units differ from the CNN engine's cycles: the fleet only compares
        the two sides of one engine to find its dominant core, never
        cycles across engines."""
        c = float(sum(req.payload.numel() if hasattr(req.payload, "numel")
                      else 1 for req, _ in self._pending))
        p = float(sum(g.batch for g in self._groups))
        return c, p

    @property
    def next_core(self) -> str | None:
        """Dominant core of the next dispatch (None when idle)."""
        if not self.has_work:
            return None
        c, p = self.next_dispatch_cycles()
        return "c" if c >= p else "p"

    # ------------------------------------------------------------------
    def step(self) -> list[Completion]:
        """One scheduler slot (see module docstring)."""
        self._start_clock()
        # shed past-deadline queue entries (ShedPolicy only), unless an
        # external clock (the fleet executor's slot) already swept
        shed = (self.shed_expired() if self._ext_clock is None
                else self._take_shed())
        r = self.runner
        done: list[tuple] = []          # (rid, tokens, ready event)
        # 1. p-core: advance active decode groups (queued, not waited on)
        for g in list(self._groups):
            q = min(m.remaining for m in g.members)
            if self.quantum is not None:
                q = min(q, self.quantum)
            if q > 0:
                r._decode_group(g, q)
                self.decode_tokens += q * g.batch
            finished: dict = {}
            if r._evict(g, finished) is None:
                self._groups.remove(g)
            done.extend((rid, out, ev) for rid, (out, ev) in finished.items())
        # 2. c-core: admit queued requests, chunked prefill each
        capacity = (self.max_in_flight if self.max_in_flight is not None
                    else len(self._pending) + self.in_flight)
        n = self.policy.admit(queued=len(self._pending),
                              in_flight=self.in_flight, capacity=capacity)
        for _ in range(max(0, min(n, len(self._pending)))):
            popped = self._pop_admission()      # None: the rest was shed
            if popped is None:
                break
            req, _ticket = popped
            self._metrics[req.rid].started_at = time.perf_counter()
            st = r.new_stream(req.payload, int(req.gen_steps), rid=req.rid)
            want = st.gen_target
            plen = st.tokens.shape[1]
            self.prefill_tokens += st.tokens.numel()
            st = r.run_prefill(st, self.prefill_chunk)
            if want <= 0:               # prefill-only request: no emit
                done.append((req.rid, st.tokens[:, :plen], st.ready))
                continue
            self.decode_tokens += st.tokens.shape[0]    # the prefill emit
            st.gen_target -= 1
            if st.gen_target <= 0:
                done.append((req.rid, st.tokens, st.ready))
            else:
                self._ready.append(st)
        # 3. fuse position-aligned ready streams into decode groups once
        #    group_size are waiting, or no further prefill can arrive now
        #    because the queue drained or admission is stalled at the
        #    in-flight cap (waiting for group_size would livelock: the cap
        #    blocks the very admissions the gate is waiting for)
        stalled = (self.max_in_flight is not None
                   and self.in_flight >= self.max_in_flight)
        buckets: dict[tuple, list] = {}
        for st in self._ready:
            buckets.setdefault((st.tokens.shape[1],), []).append(st)
        self._ready = []
        for bucket in buckets.values():
            while (self.group_size is not None
                   and len(bucket) >= self.group_size) \
                    or (bucket and (not self._pending or stalled)):
                width = (self.group_size if self.group_size is not None
                         else len(bucket))
                take, bucket = bucket[:width], bucket[width:]
                self.fused_sizes.append(len(take))
                self._groups.append(r._fuse(take))
            self._ready.extend(bucket)
        # 4. wait for this slot's finished outputs only now, after every
        #    launch of the slot is queued
        return shed + [self._finish(rid, out, ev) for rid, out, ev in done]

    # ------------------------------------------------------------------
    def retune(self, *, group_size: int | None = None,
               quantum: int | None = None,
               prefill_chunk: int | None = None) -> dict:
        """Adjust serving knobs mid-run (the SET_PARAM hook).

        Only the knobs passed change; each affects work scheduled *after*
        the call: live decode groups keep the width they were fused at
        (and the lane they run on), so a ``group_size`` change takes
        effect at the next fuse.  Returns the knobs' new values.  Every
        retune is logged on :attr:`retunes` as ``(fuses so far, {knob:
        value})`` for the stats breakdown.
        """
        changed: dict[str, int | None] = {}
        if group_size is not None:
            gs = int(group_size)
            if gs < 1:
                raise ValueError(f"group_size must be >= 1 (got {gs})")
            self.group_size = gs
            changed["group_size"] = gs
        if quantum is not None:
            q = int(quantum)
            if q < 1:
                raise ValueError(f"quantum must be >= 1 (got {q})")
            self.quantum = q
            changed["quantum"] = q
        if prefill_chunk is not None:
            pc = int(prefill_chunk)
            if pc < 1:
                raise ValueError(f"prefill_chunk must be >= 1 (got {pc})")
            self.prefill_chunk = pc
            changed["prefill_chunk"] = pc
        if changed:
            self.retunes.append((len(self.fused_sizes), changed))
        return {"group_size": self.group_size, "quantum": self.quantum,
                "prefill_chunk": self.prefill_chunk}

    # ------------------------------------------------------------------
    def _extra_stats(self, metrics: Metrics) -> dict:
        total = self.prefill_tokens + self.decode_tokens
        wall = metrics.wall_s
        return {"engine": "dualmesh",
                "n_streams": len(self._order),
                "group_size": self.group_size,
                "retunes": [{"at_fuse": i, **kv}
                            for i, kv in self.retunes],
                "fused_sizes": list(self.fused_sizes),
                "prefill_tokens": self.prefill_tokens,
                "decode_tokens": self.decode_tokens,
                "total_tokens": total,
                "tokens_per_s": total / wall if wall else float("inf")}

    def _trace_snapshot(self) -> list:
        return self.runner.trace[self._trace_start:]
