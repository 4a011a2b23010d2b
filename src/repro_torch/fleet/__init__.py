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

Closed-loop SLO adaptation: a :class:`ControlLoop` attached to a fleet
observes a sliding completion window every K slots and injects SET_PARAM
(member weight, LM fusion width) and REBALANCE (a re-split of the card's
SMs) instructions into the recorded stream, with a seq-watermarked
decision log as the audit trail; controlled runs replay bitwise with no
controller attached, and decision logs are byte-compatible with the
reference's.  An LM ``DualMeshEngine`` serves beside CNN members as an
opaque member (fused RUNs).
"""
from repro_torch.fleet.compiler import (SlotCompiler, compile_fleet,
                                        stream_signature, validate_stream)
from repro_torch.fleet.control import (ControlAction, ControlLoop,
                                       Decision, RebalanceTheta, Retune,
                                       Reweight, decisions_from_json,
                                       decisions_to_json, dump_decisions,
                                       load_decisions, lower_action,
                                       verify_decisions)
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
    "ControlAction",
    "ControlLoop",
    "DeadlineEDF",
    "Decision",
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
    "RebalanceTheta",
    "RecoveryConfig",
    "Recv",
    "RemoteFleet",
    "Retune",
    "Reweight",
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
    "decisions_from_json",
    "decisions_to_json",
    "dump_decisions",
    "dump_stream",
    "load_decisions",
    "load_stream",
    "lower_action",
    "make_policy",
    "mix_schedule",
    "normalize_mix",
    "plan_fleet",
    "plan_rows",
    "start_workers",
    "stop_workers",
    "stream_from_json",
    "stream_signature",
    "stream_to_json",
    "validate_stream",
    "verify_decisions",
]
