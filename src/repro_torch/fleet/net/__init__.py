"""In-process fleet transport: the wire format and the SEND/RECV mailboxes.

``wire`` frames versioned JSON envelopes and encodes payloads;
``transport`` binds the router's SEND/RECV mailbox in memory
(:class:`LocalTransport`) or in a spool directory
(:class:`FileTransport`).
"""
from repro_torch.fleet.net.transport import FileTransport, LocalTransport
from repro_torch.fleet.net.wire import (WIRE_VERSION, WireClosed, WireError,
                                        decode_completion, decode_request,
                                        decode_value, encode_completion,
                                        encode_request, encode_value,
                                        read_env, write_env)

__all__ = [
    "WIRE_VERSION", "WireClosed", "WireError",
    "decode_completion", "decode_request", "decode_value",
    "encode_completion", "encode_request", "encode_value",
    "read_env", "write_env",
    "FileTransport", "LocalTransport",
]
