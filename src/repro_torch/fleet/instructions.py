"""Fleet instruction set: the serializable form of fleet execution.

Every cross-engine decision of the fleet (policy pick, core-complementary
co-dispatch ordering, burst) lowers to one of six instructions, so that a
pool's execution is a serializable stream rather than a Python loop over
its engines (the compile-the-schedule-then-replay move the paper's own
overlay ISA makes in ``core/isa.py``):

  RUN        advance one member's exec-group pipeline up to ``slots``
             consecutive scheduler slots on its cores (``fused`` marks
             members without the advance/retire split, whose step() blocks)
  FREE       materialize + release the member's finished in-flight slots
             (the block-last rule: every RUN of a slot precedes any FREE)
  SEND       emit ``count`` queued requests of one member out of this pool
             toward a peer pool (cross-pool migration / drain)
  RECV       accept requests a peer SENT and enqueue them on the member
  REBALANCE  re-split this pool's c/p cores at a new theta (dynamic
             re-leasing when the observed traffic mix drifts; on one card
             the SMs are split anew)
  SET_PARAM  set one tunable of a member mid-run (fleet weight share, or
             a keyword of the member engine's ``retune``) (schema v2)

Instructions are plain frozen dataclasses, JSON-serializable under a
versioned schema (:data:`SCHEMA_VERSION`); :class:`ExecRecord` wraps one
executed instruction with its observed slot, sequence number, advance
count and wall-clock window — the executed stream is what round-trips
through JSON (``stream_to_json`` / ``stream_from_json``), replays through
``fleet.executor.PoolExecutor.replay``, and exports to Chrome tracing
(``fleet.trace``).

Schema v2 adds SET_PARAM and nothing else.  The compatibility rule: a v1
stream is a valid v2 stream (no v1 op changed shape or meaning), so v1
recordings replay unchanged; a stream that *claims* version 1 but
contains SET_PARAM is schema drift and a hard error, like any unknown
op or field.

Copy of ``repro/fleet/instructions.py``: the JSON is byte-compatible, so
a stream recorded by either package loads and replays on the other.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Sequence

SCHEMA_VERSION = 2

#: schema versions ``stream_from_json`` accepts: v1 streams predate
#: SET_PARAM but are otherwise identical, and must replay unchanged
COMPAT_VERSIONS = (1, 2)

OPS = ("RUN", "FREE", "SEND", "RECV", "REBALANCE", "SET_PARAM")

#: ops only a ``version >= 2`` stream may carry
_V2_OPS = ("SET_PARAM",)


@dataclasses.dataclass(frozen=True)
class Run:
    """Advance ``member``'s pipeline up to ``slots`` consecutive scheduler
    slots.  ``core`` is the predicted dominant core of the dispatch
    ('c' | 'p' | None when the compiler did not price it); ``primary``
    marks the scheduling policy's pick for the slot; ``fused`` marks an
    opaque member whose step() fuses dispatch and block (it must execute
    after every pure dispatch of the slot)."""

    member: str
    slots: int = 1
    core: str | None = None
    primary: bool = False
    fused: bool = False

    op = "RUN"


@dataclasses.dataclass(frozen=True)
class Free:
    """Materialize the outputs of ``member``'s finished streams and free
    their pipeline slots.  FREEs trail every RUN of the slot — blocking
    earlier would serialize exactly the cross-network overlap the fleet
    exists for."""

    member: str

    op = "FREE"


@dataclasses.dataclass(frozen=True)
class Send:
    """Withdraw up to ``count`` queued (unadmitted) requests of ``member``
    from this pool and hand them to pool ``peer`` (None member = every
    member).  The matching :class:`Recv` executes on the peer; the router
    carries the payloads through its mailbox — payloads never appear in
    the serialized stream."""

    peer: str
    member: str | None = None
    count: int | None = None

    op = "SEND"


@dataclasses.dataclass(frozen=True)
class Recv:
    """Enqueue the requests pool ``peer`` SENT onto this pool's members
    (each request carries its model tag; ``count`` is the observed number
    accepted, stamped by the executor)."""

    peer: str
    count: int | None = None

    op = "RECV"


@dataclasses.dataclass(frozen=True)
class Rebalance:
    """Re-split this pool's c/p cores at ``theta`` (Eq.10): revoke every
    lease, re-lease the new split, and relocate the members onto it
    (in-flight envs keep their position)."""

    theta: float

    op = "REBALANCE"


@dataclasses.dataclass(frozen=True)
class SetParam:
    """Set one tunable parameter of ``member`` mid-run (schema v2).

    ``param`` is either ``"weight"`` (the member's fleet share, applied
    by the executor directly) or the name of a keyword the member
    engine's ``retune()`` hook accepts (e.g. ``"group_size"``, the LM
    decode fusion width).  Because the mutation is a recorded
    instruction rather than a side effect, a run that changed it replays
    bitwise with nothing else attached.
    """

    member: str
    param: str
    value: float

    op = "SET_PARAM"


Instruction = Run | Free | Send | Recv | Rebalance | SetParam

_OP_TYPES = {"RUN": Run, "FREE": Free, "SEND": Send, "RECV": Recv,
             "REBALANCE": Rebalance, "SET_PARAM": SetParam}


@dataclasses.dataclass
class ExecRecord:
    """One executed instruction: the instruction plus what execution
    observed — the fleet slot it ran in, a router-wide sequence number
    (replay interleaves multi-pool streams by it), how many scheduler
    slots a RUN actually advanced (burst truncates at an empty pipeline),
    and the wall-clock window (perf_counter seconds) for trace export."""

    instr: Instruction
    slot: int
    seq: int = 0
    advances: int = 0
    t0: float | None = None
    t1: float | None = None
    retries: int = 0      # attempts re-issued after injected RUN faults
    #                       (observational, like t0/t1: excluded from
    #                       stream_signature so a clean replay of a
    #                       faulted recording still matches bitwise)


def instr_to_dict(instr: Instruction) -> dict:
    """One instruction -> its JSON record (``op`` plus fields)."""
    d = {"op": instr.op}
    d.update(dataclasses.asdict(instr))
    return d


def instr_from_dict(d: dict) -> Instruction:
    """Inverse of :func:`instr_to_dict`; unknown ops or fields raise."""
    d = dict(d)
    op = d.pop("op", None)
    if op not in _OP_TYPES:
        raise ValueError(f"unknown fleet instruction op {op!r}; "
                         f"one of {OPS}")
    cls = _OP_TYPES[op]
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - fields
    if unknown:
        raise ValueError(f"{op} instruction has unknown fields "
                         f"{sorted(unknown)} (schema drift? expected "
                         f"{sorted(fields)})")
    return cls(**d)


def stream_to_json(records: Sequence[ExecRecord], *,
                   pool: str | None = None) -> dict:
    """Serialize an executed (or compiled) stream.  Compiled-only records
    carry ``t0``/``t1`` = None; both forms round-trip."""
    return {
        "version": SCHEMA_VERSION,
        "pool": pool,
        "records": [{
            "instr": instr_to_dict(r.instr),
            "slot": r.slot,
            "seq": r.seq,
            "advances": r.advances,
            "t0": r.t0,
            "t1": r.t1,
            **({"retries": r.retries} if r.retries else {}),
        } for r in records],
    }


def stream_from_json(doc: dict) -> list[ExecRecord]:
    """Deserialize a stream, accepting any :data:`COMPAT_VERSIONS` schema.

    v1 streams (pre-SET_PARAM) load and replay unchanged; a v1 document
    that nevertheless carries a v2-only op is schema drift and raises.
    """
    version = doc.get("version")
    if version not in COMPAT_VERSIONS:
        raise ValueError(f"fleet instruction stream schema version "
                         f"{version!r} not in supported {COMPAT_VERSIONS}")
    if version < SCHEMA_VERSION:
        drift = [r["instr"].get("op") for r in doc["records"]
                 if r["instr"].get("op") in _V2_OPS]
        if drift:
            raise ValueError(
                f"stream claims schema version {version} but contains "
                f"version-{SCHEMA_VERSION} ops {sorted(set(drift))} "
                f"(schema drift)")
    return [ExecRecord(instr=instr_from_dict(r["instr"]), slot=r["slot"],
                       seq=r.get("seq", 0), advances=r.get("advances", 0),
                       t0=r.get("t0"), t1=r.get("t1"),
                       retries=r.get("retries", 0))
            for r in doc["records"]]


def dump_stream(records: Sequence[ExecRecord], path: str, *,
                pool: str | None = None) -> None:
    """Write :func:`stream_to_json` to ``path``."""
    with open(path, "w") as f:
        json.dump(stream_to_json(records, pool=pool), f, indent=1)


def load_stream(path: str) -> list[ExecRecord]:
    """Read a stream document written by :func:`dump_stream`."""
    with open(path) as f:
        return stream_from_json(json.load(f))
