"""repro_torch.fleet — several CNNs served over one device pool.

Port of ``repro/fleet`` for CNN members, in one process.  A
:class:`DevicePool` leases its c/p split (two green contexts on disjoint
SMs of the card, a stream each) to every member engine; a
:class:`Router` routes model-tagged requests and a
:class:`SchedulingPolicy` picks which member's exec groups dispatch each
step; :class:`FleetEngine` serves the members through the serving
protocol, interleaving core-complementary groups of *different* networks
on the two cores; :func:`plan_fleet` co-schedules a ``{model: qps
share}`` mix through the §V-B design-space search (the Table VII flow).

Execution is instruction-based: every ``FleetEngine.step`` lowers its
decisions to RUN/FREE instructions (:mod:`~repro_torch.fleet.instructions`,
:mod:`~repro_torch.fleet.compiler`) that a :class:`PoolExecutor` executes
and records; :func:`compile_fleet` lowers a whole run ahead of time, and
:class:`MultiPoolRouter` drives N in-process pools as one engine with
SEND/RECV migration, REBALANCE re-leasing, and recovery from a seeded
:class:`FaultPlan`.  Streams, fault plans and wire payloads are
byte-compatible with the reference package's, so a stream recorded by
either replays on the other.

The fleet across processes: :func:`start_workers` spawns one worker
process per pool (``python -m repro_torch.fleet.worker``), and
:func:`connect` gives a :class:`RemoteFleet` per worker, which a
:class:`MultiPoolRouter` drives over the socket transport as it drives
in-process pools (:mod:`~repro_torch.fleet.net`).

Not ported yet (ROADMAP): the closed-loop controller
(``fleet/control.py``) and LM members.
"""
from repro_torch.fleet.compiler import (SlotCompiler, compile_fleet,
                                        stream_signature, validate_stream)
from repro_torch.fleet.engine import FleetEngine, Member, build_cnn_fleet
from repro_torch.fleet.executor import MultiPoolRouter, PoolExecutor
from repro_torch.fleet.faults import (Fault, FaultInjector, FaultPlan,
                                      InjectedFault, PoolCrash,
                                      RecoveryConfig)
from repro_torch.fleet.instructions import (COMPAT_VERSIONS, SCHEMA_VERSION,
                                            ExecRecord, Free, Instruction,
                                            Rebalance, Recv, Run, Send,
                                            SetParam, dump_stream,
                                            load_stream, stream_from_json,
                                            stream_to_json)
from repro_torch.fleet.net import (FileTransport, LocalTransport,
                                   SocketTransport)
from repro_torch.fleet.net.coordinator import (RemoteFleet, WorkerProc,
                                               connect, start_workers,
                                               stop_workers)
from repro_torch.fleet.planner import (FleetPlan, mix_schedule,
                                       normalize_mix, plan_fleet, plan_rows)
from repro_torch.fleet.pool import DevicePool, Lease
from repro_torch.fleet.router import (POLICY_NAMES, DeadlineEDF, MemberView,
                                      RoundRobin, Router, SchedulingPolicy,
                                      ShortestQueue, WeightedFair,
                                      make_policy)

__all__ = [
    "COMPAT_VERSIONS",
    "DeadlineEDF",
    "DevicePool",
    "ExecRecord",
    "Fault",
    "FaultInjector",
    "FaultPlan",
    "FileTransport",
    "FleetEngine",
    "FleetPlan",
    "Free",
    "InjectedFault",
    "Instruction",
    "Lease",
    "LocalTransport",
    "Member",
    "MemberView",
    "MultiPoolRouter",
    "POLICY_NAMES",
    "PoolCrash",
    "PoolExecutor",
    "Rebalance",
    "RecoveryConfig",
    "Recv",
    "RemoteFleet",
    "RoundRobin",
    "Router",
    "Run",
    "SCHEMA_VERSION",
    "SchedulingPolicy",
    "Send",
    "SetParam",
    "ShortestQueue",
    "SlotCompiler",
    "SocketTransport",
    "WeightedFair",
    "WorkerProc",
    "build_cnn_fleet",
    "compile_fleet",
    "connect",
    "dump_stream",
    "load_stream",
    "make_policy",
    "mix_schedule",
    "normalize_mix",
    "plan_fleet",
    "plan_rows",
    "stream_from_json",
    "stream_signature",
    "start_workers",
    "stop_workers",
    "stream_to_json",
    "validate_stream",
]
