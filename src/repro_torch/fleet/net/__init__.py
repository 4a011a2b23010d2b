"""Fleet transport: the wire format, the SEND/RECV mailboxes, and the
fleet across processes.

``wire`` frames versioned JSON envelopes and encodes payloads;
``transport`` implements the SEND/RECV mailbox surface three ways (in
memory, spool files, sockets); ``coordinator`` drives N worker processes
through the unchanged ``MultiPoolRouter`` placement, migration and
recovery logic; ``worker`` is the per-pool process
(``python -m repro_torch.fleet.worker``).
"""
from repro_torch.fleet.net.transport import (FileTransport, LocalTransport,
                                             SocketTransport)
from repro_torch.fleet.net.wire import (WIRE_VERSION, Channel, WireClosed,
                                        WireError, decode_completion,
                                        decode_request, decode_value,
                                        encode_completion, encode_request,
                                        encode_value, read_env, write_env)

__all__ = [
    "WIRE_VERSION", "Channel", "WireClosed", "WireError",
    "decode_completion", "decode_request", "decode_value",
    "encode_completion", "encode_request", "encode_value",
    "read_env", "write_env",
    "FileTransport", "LocalTransport", "SocketTransport",
    "RemoteFleet", "WorkerHandle", "WorkerProc", "connect",
    "start_workers", "stop_workers",
]


def __getattr__(name):
    """Lazy coordinator exports: ``coordinator`` builds on the executor,
    which imports this package for :class:`LocalTransport`; importing it
    on first use breaks the cycle."""
    if name in ("RemoteFleet", "WorkerHandle", "WorkerProc", "connect",
                "start_workers", "stop_workers"):
        from repro_torch.fleet.net import coordinator
        return getattr(coordinator, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
