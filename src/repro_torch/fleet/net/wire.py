"""Wire format of the fleet: framed envelopes and the payload codec.

Port of ``repro/fleet/net/wire.py`` (wire v2), byte-compatible with it.
One message is an **envelope**: a 4-byte big-endian length prefix
followed by that many bytes of UTF-8 JSON.  Every envelope carries ``v``
(the wire schema version) and ``kind``; the remaining fields are
kind-specific and validated against a per-kind whitelist on *read* — an
unknown kind, an unknown field, or a version mismatch is schema drift and
raises :class:`WireError`, like the instruction-stream schema.  Envelopes
are the :class:`~repro_torch.fleet.net.transport.FileTransport` spool
frames and the coordinator/worker RPCs of a fleet across processes, over
a :class:`Channel`.

The RPC surface is strict request-reply, with one carve-out: while
serving a ``step``/``inject`` RPC a worker may issue ``migrate_*``
**upcalls** (its SEND/RECV instructions need the coordinator's mailbox);
the coordinator answers each inline and keeps waiting for the original
reply, so frames never interleave.

Payload values (request payloads, completion outputs) are JSON with two
tagged escape hatches: arrays ride as ``{"__nd__": [dtype, shape,
base64]}`` and raw bytes as ``{"__b__": base64}``.  A tensor is copied to
the host first (a CUDA tensor explicitly), so its encoding equals the
reference's for the same numpy array; decoding gives a CPU tensor, which
the runner's ``place_input`` moves to the card.
"""
from __future__ import annotations

import base64
import json
import struct

import numpy as np
import torch

from repro_torch.serving.api import Completion, Request, RequestMetrics, Ticket

#: wire schema version; envelopes are stamped with it.  v2 added the
#: telemetry pull (``telemetry``/``telemetry_snap``); everything a v1
#: peer could say is unchanged, so both versions stay readable
WIRE_VERSION = 2
#: versions this reader accepts
WIRE_COMPAT = (1, 2)
#: kinds that did not exist in v1 — a v1 envelope carrying one is drift
_V2_KINDS = ("telemetry", "telemetry_snap")

_LEN = struct.Struct(">I")
_MAX_FRAME = 1 << 30    # 1 GiB: a corrupt length prefix fails loudly


class WireError(ValueError):
    """Protocol violation: bad framing, version or kind/field drift."""


class WireClosed(WireError):
    """The peer closed the connection at a frame boundary (or mid-frame,
    which additionally means a message was truncated)."""


#: envelope kinds -> the fields each may carry (beyond ``v``/``kind``).
#: Coordinator -> worker: hello, submit, step, inject, ping, shutdown.
#: Worker -> coordinator: the ``*_ack``/``*_done`` replies, ``error``,
#: and the migrate upcalls issued mid-RPC.  ``frame`` is the on-disk
#: spool format of :class:`~repro_torch.fleet.net.transport.FileTransport`.
ENVELOPE_FIELDS: dict[str, frozenset] = {
    "hello": frozenset({"pool"}),
    "hello_ack": frozenset({"pool", "schema", "members", "state"}),
    "submit": frozenset({"req", "seq"}),
    "submit_ack": frozenset({"rid", "records", "completions", "state"}),
    "step": frozenset({"seq"}),
    "step_done": frozenset({"records", "completions", "state"}),
    "inject": frozenset({"instr", "seq"}),
    "inject_done": frozenset({"records", "completions", "state"}),
    "migrate_out": frozenset({"src", "dst", "pairs"}),
    "migrate_ack": frozenset({"n"}),
    "migrate_drop": frozenset({"src", "dst", "pairs", "seq", "live"}),
    "migrate_req": frozenset({"src", "dst", "count"}),
    "migrate_deliver": frozenset({"items"}),
    "migrate_map": frozenset({"dst", "mapped"}),
    "migrate_map_ack": frozenset({"n"}),
    "ping": frozenset(),
    "pong": frozenset({"state"}),
    "telemetry": frozenset(),
    "telemetry_snap": frozenset({"snapshot"}),
    "shutdown": frozenset(),
    "bye": frozenset(),
    "error": frozenset({"etype", "msg", "records", "completions",
                        "state"}),
    "frame": frozenset({"src", "dst", "items"}),
}


def pack_env(env: dict) -> bytes:
    """Serialize one envelope to its framed wire bytes (stamping ``v``)."""
    kind = env.get("kind")
    if kind not in ENVELOPE_FIELDS:
        raise WireError(f"unknown envelope kind {kind!r}; one of "
                        f"{sorted(ENVELOPE_FIELDS)}")
    doc = {"v": WIRE_VERSION, **env}
    body = json.dumps(doc, separators=(",", ":")).encode()
    return _LEN.pack(len(body)) + body


def _validate(doc: dict) -> dict:
    v = doc.get("v")
    if v not in WIRE_COMPAT:
        raise WireError(f"wire version {v!r} not in {WIRE_COMPAT} "
                        f"(peer speaks a different protocol)")
    kind = doc.get("kind")
    if v < 2 and kind in _V2_KINDS:
        raise WireError(f"v{v} envelope carries the v2-only kind "
                        f"{kind!r} (wire drift)")
    allowed = ENVELOPE_FIELDS.get(kind)
    if allowed is None:
        raise WireError(f"unknown envelope kind {kind!r}; one of "
                        f"{sorted(ENVELOPE_FIELDS)}")
    extra = set(doc) - allowed - {"v", "kind"}
    if extra:
        raise WireError(f"{kind} envelope has unknown fields "
                        f"{sorted(extra)} (wire drift? expected a subset "
                        f"of {sorted(allowed)})")
    return doc


def unpack_env(body: bytes) -> dict:
    """Parse and validate one envelope body (the bytes after the length
    prefix)."""
    try:
        doc = json.loads(body.decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise WireError(f"undecodable envelope body: {e}") from None
    if not isinstance(doc, dict):
        raise WireError(f"envelope body is {type(doc).__name__}, "
                        f"not an object")
    return _validate(doc)


def write_env(f, env: dict) -> None:
    """Write one framed envelope to a binary file-like and flush."""
    f.write(pack_env(env))
    f.flush()


def read_env(f) -> dict:
    """Read one framed envelope from a binary file-like.  A clean EOF at
    the frame boundary (and a truncated frame) raise :class:`WireClosed`;
    anything malformed raises :class:`WireError`."""
    head = f.read(_LEN.size)
    if not head:
        raise WireClosed("peer closed the connection")
    if len(head) < _LEN.size:
        raise WireClosed(f"truncated length prefix "
                         f"({len(head)}/{_LEN.size} bytes)")
    (n,) = _LEN.unpack(head)
    if n > _MAX_FRAME:
        raise WireError(f"frame length {n} exceeds the {_MAX_FRAME}-byte "
                        f"cap (corrupt prefix?)")
    body = b""
    while len(body) < n:
        chunk = f.read(n - len(body))
        if not chunk:
            raise WireClosed(f"truncated frame ({len(body)}/{n} bytes)")
        body += chunk
    return unpack_env(body)


class Channel:
    """One framed-envelope connection over a socket.

    ``timeout_s`` is the read deadline, the coordinator's heartbeat: a
    worker that stays silent past it raises ``TimeoutError``, which the
    coordinator escalates to a pool crash."""

    obs = None      # optional repro_torch.obs.Registry for net_* metrics

    def __init__(self, sock, *, timeout_s: float | None = None):
        sock.settimeout(timeout_s)
        self._sock = sock
        self._f = sock.makefile("rwb")

    def _count(self, direction: str, kind, nbytes: int = 0) -> None:
        obs = self.obs
        if obs is None or not obs.enabled:
            return
        # wall domain: what crossed this wire depends on transport and
        # timing, never on the instruction stream
        obs.counter("net_envelopes_total", "envelopes on the wire",
                    "wall").inc(labels={"dir": direction,
                                        "kind": str(kind)})
        if nbytes:
            obs.counter("net_bytes_total", "framed bytes sent",
                        "wall").inc(nbytes, labels={"dir": direction})

    def send(self, env: dict) -> None:
        """Write one envelope and flush."""
        buf = pack_env(env)
        self._f.write(buf)
        self._f.flush()
        self._count("out", env.get("kind"), len(buf))

    def recv(self) -> dict:
        """Read one envelope (blocking, up to the channel timeout)."""
        env = read_env(self._f)
        self._count("in", env.get("kind"))
        return env

    def close(self) -> None:
        """Close the file wrapper and the underlying socket."""
        for obj in (self._f, self._sock):
            try:
                obj.close()
            except OSError:
                pass


# --------------------------------------------------------------------------
# payload codec
# --------------------------------------------------------------------------
_ND_TAG = "__nd__"
_BYTES_TAG = "__b__"


def encode_value(x):
    """JSON-encodable form of a payload value: arrays (numpy, or tensors
    copied to the host) and bytes are tagged + base64'd; containers
    recurse; scalars pass through; anything else is not wire-safe and
    raises."""
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, bytes):
        return {_BYTES_TAG: base64.b64encode(x).decode()}
    if isinstance(x, (list, tuple)):
        return [encode_value(v) for v in x]
    if isinstance(x, dict):
        for tag in (_ND_TAG, _BYTES_TAG):
            if tag in x:
                raise WireError(f"dict payload uses the reserved key "
                                f"{tag!r}")
        return {str(k): encode_value(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    if hasattr(x, "dtype") and hasattr(x, "shape"):
        a = np.asarray(x)
        return {_ND_TAG: [str(a.dtype), list(a.shape),
                          base64.b64encode(np.ascontiguousarray(a)
                                           .tobytes()).decode()]}
    raise WireError(f"payload value of type {type(x).__name__} is not "
                    f"wire-serializable")


def decode_value(x):
    """Inverse of :func:`encode_value`; arrays come back as CPU
    tensors."""
    if isinstance(x, list):
        return [decode_value(v) for v in x]
    if isinstance(x, dict):
        if _ND_TAG in x:
            dtype, shape, b64 = x[_ND_TAG]
            a = np.frombuffer(base64.b64decode(b64), dtype=np.dtype(dtype))
            return torch.from_numpy(a.reshape(shape).copy())
        if _BYTES_TAG in x:
            return base64.b64decode(x[_BYTES_TAG])
        return {k: decode_value(v) for k, v in x.items()}
    return x


def encode_request(req: Request) -> dict:
    """Wire document for one request (rids never cross the wire — each
    side keeps its own request-id domain)."""
    return {"payload": encode_value(req.payload),
            "gen_steps": req.gen_steps,
            "model": req.model,
            "deadline": req.deadline,
            "priority": req.priority}


def decode_request(doc: dict) -> Request:
    """Inverse of :func:`encode_request`."""
    return Request(payload=decode_value(doc["payload"]),
                   gen_steps=doc["gen_steps"],
                   model=doc["model"],
                   deadline=doc["deadline"],
                   priority=doc["priority"])


def encode_completion(c: Completion) -> dict:
    """Wire document for one completion (member-rid domain)."""
    m = c.metrics
    return {"ticket": [c.ticket.rid, c.ticket.submitted_at],
            "output": encode_value(c.output),
            "metrics": {"rid": m.rid, "submitted_at": m.submitted_at,
                        "started_at": m.started_at,
                        "finished_at": m.finished_at, "model": m.model,
                        "status": m.status, "deadline": m.deadline,
                        "slo_ok": m.slo_ok}}


def decode_completion(doc: dict) -> Completion:
    """Inverse of :func:`encode_completion`."""
    rid, sub = doc["ticket"]
    return Completion(ticket=Ticket(rid=rid, submitted_at=sub),
                      output=decode_value(doc["output"]),
                      metrics=RequestMetrics(**doc["metrics"]))
