"""SEND/RECV transports behind ``PoolExecutor``'s mailbox surface.

Port of ``repro/fleet/net/transport.py``.  A transport carries migrated
request payloads between pools; the *accounting* (rid translation,
recovery events, live re-routes) stays on the
:class:`~repro_torch.fleet.executor.MultiPoolRouter`, reached through three
hooks — ``on_send`` / ``on_drop`` / ``on_recv`` — so every transport keeps
identical books.  The executor-facing surface is what SEND/RECV
instructions call:

    send(src, dst, pairs)                   deliver withdrawn requests
    drop_send(src, dst, pairs, seq, live)   a SEND lost in transit
    recv(dst, src, count, submit)           drain into the destination

and the router-facing surface is what placement, migration accounting
and crash recovery call:

    bind(router)        attach the owning router (its hooks)
    in_transit          total payloads riding the mailbox
    pending(src, dst)   payloads on one edge
    take(src, dst, n)   pop payloads without submitting them (the
                        coordinator delivers them to a remote RECV)
    drain_for(dst)      pop every payload addressed to a dead pool,
                        returning the stranded router rids

:class:`LocalTransport` is an in-memory deque.  :class:`FileTransport`
spools each SEND as a framed ``frame`` envelope file (one file per SEND,
consumed head-first by RECV), in the wire format the reference writes.
:class:`SocketTransport` is the *worker-side* binding: it forwards the
three executor calls to the coordinator as ``migrate_*`` upcalls on the
worker's control channel (``net.coordinator`` is the other side).
"""
from __future__ import annotations

import os
from collections import deque

from repro_torch.fleet.net import wire


class LocalTransport:
    """In-memory (src, dst) -> deque mailbox; the default binding for
    process-local multi-pool serving."""

    obs = None     # optional repro_torch.obs.Registry (the router sets it)

    def __init__(self):
        self.router = None
        self._mail: dict[tuple[str, str], deque] = {}

    def bind(self, router) -> None:
        """Attach the owning router (accounting hooks)."""
        self.router = router

    # executor-facing ---------------------------------------------------
    def send(self, src: str, dst: str, pairs) -> int:
        """Deliver withdrawn requests into the (src, dst) mailbox; the
        router's ``on_send`` translates rids (and may swallow the SEND
        during the replay of a recorded drop)."""
        carried = self.router.on_send(src, dst, pairs)
        if carried is not None:
            self._mail.setdefault((src, dst), deque()).extend(carried)
        return len(pairs)

    def drop_send(self, src: str, dst: str, pairs, *, seq: int,
                  live: bool) -> int:
        """A SEND lost in transit: nothing is carried; the router logs
        the drop and (live) re-routes the payloads."""
        return self.router.on_drop(src, dst, pairs, seq=seq, live=live)

    def recv(self, dst: str, src: str, count: int | None, submit) -> int:
        """Drain up to ``count`` mailbox payloads into ``submit`` on the
        destination pool."""
        n = 0
        for rid, req in self.take(src, dst, count):
            self.router.on_recv(dst, rid, submit(req).rid)
            n += 1
        return n

    # router-facing -----------------------------------------------------
    @property
    def in_transit(self) -> int:
        """Total payloads riding the mailbox."""
        return sum(len(box) for box in self._mail.values())

    def pending(self, src: str, dst: str) -> int:
        """Payloads waiting on the (src, dst) edge."""
        return len(self._mail.get((src, dst), ()))

    def take(self, src: str, dst: str,
             count: int | None) -> list[tuple[int, object]]:
        """Pop up to ``count`` (router rid, Request) payloads from the
        (src, dst) edge without submitting them."""
        box = self._mail.get((src, dst))
        out: list[tuple[int, object]] = []
        while box and (count is None or len(out) < count):
            out.append(box.popleft())
        return out

    def drain_for(self, dst: str) -> list[int]:
        """Pop every payload addressed to ``dst`` (it died); return the
        stranded router rids for recovery."""
        lost: list[int] = []
        for (_s, d), box in self._mail.items():
            if d == dst:
                while box:
                    rid, _req = box.popleft()
                    lost.append(rid)
        return lost


class FileTransport:
    """Spool-directory mailbox: each SEND is one framed ``frame``
    envelope file under ``spool_dir``, named ``NNNNNNNN.src.dst.frame``
    so lexical order is delivery order.  RECV consumes files head-first,
    rewriting a partially-consumed frame in place.  Everything on disk is
    the wire format — inspectable with ``wire.read_env`` — which is the
    point: a spool directory is a replayable, debuggable trace of every
    payload that crossed pools."""

    obs = None     # optional repro_torch.obs.Registry (the router sets it)

    def __init__(self, spool_dir: str):
        os.makedirs(spool_dir, exist_ok=True)
        self.spool_dir = spool_dir
        self.router = None
        self._n = 0     # monotonically-named frames, delivery order

    def bind(self, router) -> None:
        """Attach the owning router (accounting hooks)."""
        self.router = router

    # spool internals ---------------------------------------------------
    def _frames(self, src: str | None = None,
                dst: str | None = None) -> list[str]:
        names = sorted(n for n in os.listdir(self.spool_dir)
                       if n.endswith(".frame"))
        out = []
        for n in names:
            _seq, s, d, _ext = n.split(".")
            if (src is None or s == src) and (dst is None or d == dst):
                out.append(n)
        return out

    def _read(self, name: str) -> dict:
        with open(os.path.join(self.spool_dir, name), "rb") as f:
            return wire.read_env(f)

    def _write(self, name: str, env: dict) -> None:
        buf = wire.pack_env(env)
        with open(os.path.join(self.spool_dir, name), "wb") as f:
            f.write(buf)
            f.flush()
        if self.obs is not None and self.obs.enabled:
            # wall domain: spool traffic depends on drop timing
            self.obs.counter("net_envelopes_total",
                             "envelopes on the wire", "wall").inc(
                labels={"dir": "out", "kind": str(env.get("kind"))})
            self.obs.counter("net_bytes_total", "framed bytes sent",
                             "wall").inc(len(buf), labels={"dir": "out"})

    # executor-facing ---------------------------------------------------
    def send(self, src: str, dst: str, pairs) -> int:
        """Spool one frame file carrying the withdrawn requests."""
        carried = self.router.on_send(src, dst, pairs)
        if carried is not None and carried:
            env = {"kind": "frame", "src": src, "dst": dst,
                   "items": [[rid, wire.encode_request(req)]
                             for rid, req in carried]}
            self._write(f"{self._n:08d}.{src}.{dst}.frame", env)
            self._n += 1
        return len(pairs)

    def drop_send(self, src: str, dst: str, pairs, *, seq: int,
                  live: bool) -> int:
        """A SEND lost in transit: no frame is spooled."""
        return self.router.on_drop(src, dst, pairs, seq=seq, live=live)

    def recv(self, dst: str, src: str, count: int | None, submit) -> int:
        """Consume spooled frames head-first into ``submit``."""
        n = 0
        for rid, req in self.take(src, dst, count):
            self.router.on_recv(dst, rid, submit(req).rid)
            n += 1
        return n

    # router-facing -----------------------------------------------------
    @property
    def in_transit(self) -> int:
        """Total payloads spooled across all edges."""
        return sum(len(self._read(n)["items"]) for n in self._frames())

    def pending(self, src: str, dst: str) -> int:
        """Payloads spooled on the (src, dst) edge."""
        return sum(len(self._read(n)["items"])
                   for n in self._frames(src, dst))

    def take(self, src: str, dst: str,
             count: int | None) -> list[tuple[int, object]]:
        """Pop up to ``count`` payloads from the (src, dst) edge,
        rewriting a partially-consumed head frame."""
        out: list[tuple[int, object]] = []
        for name in self._frames(src, dst):
            if count is not None and len(out) >= count:
                break
            env = self._read(name)
            items = env["items"]
            room = (len(items) if count is None
                    else min(len(items), count - len(out)))
            out.extend((rid, wire.decode_request(doc))
                       for rid, doc in items[:room])
            rest = items[room:]
            path = os.path.join(self.spool_dir, name)
            if rest:
                self._write(name, {**env, "items": rest})
            else:
                os.remove(path)
        return out

    def drain_for(self, dst: str) -> list[int]:
        """Delete every frame addressed to ``dst``; return the stranded
        router rids."""
        lost: list[int] = []
        for name in self._frames(dst=dst):
            lost.extend(rid for rid, _doc in self._read(name)["items"])
            os.remove(os.path.join(self.spool_dir, name))
        return lost


class SocketTransport:
    """Worker-side SEND/RECV binding: each executor call becomes a
    ``migrate_*`` upcall on the worker's control channel, answered
    inline by the coordinator (which owns the real mailbox and the
    router hooks).  Only the executor-facing surface exists here: a
    worker never sees the fleet-wide mailbox."""

    def __init__(self, channel: wire.Channel):
        self.chan = channel

    def _ack(self, expect: str) -> dict:
        env = self.chan.recv()
        if env["kind"] == "error":
            raise _raise_remote(env)
        if env["kind"] != expect:
            raise wire.WireError(f"expected {expect!r} from the "
                                 f"coordinator, got {env['kind']!r}")
        return env

    def send(self, src: str, dst: str, pairs) -> int:
        """Ship withdrawn requests up to the coordinator's mailbox."""
        self.chan.send({"kind": "migrate_out", "src": src, "dst": dst,
                        "pairs": [[frid, wire.encode_request(req)]
                                  for frid, req in pairs]})
        return self._ack("migrate_ack")["n"]

    def drop_send(self, src: str, dst: str, pairs, *, seq: int,
                  live: bool) -> int:
        """Report a dropped SEND so the coordinator logs and re-routes."""
        self.chan.send({"kind": "migrate_drop", "src": src, "dst": dst,
                        "pairs": [[frid, wire.encode_request(req)]
                                  for frid, req in pairs],
                        "seq": seq, "live": live})
        return self._ack("migrate_ack")["n"]

    def recv(self, dst: str, src: str, count: int | None, submit) -> int:
        """Pull payloads for a RECV from the coordinator's mailbox, then
        report the member-rid mapping so the coordinator re-accounts."""
        self.chan.send({"kind": "migrate_req", "src": src, "dst": dst,
                        "count": count})
        items = self._ack("migrate_deliver")["items"]
        mapped = [[rid, submit(wire.decode_request(doc)).rid]
                  for rid, doc in items]
        self.chan.send({"kind": "migrate_map", "dst": dst,
                        "mapped": mapped})
        self._ack("migrate_map_ack")
        return len(mapped)


def _raise_remote(env: dict) -> Exception:
    """Re-raise a coordinator ``error`` envelope worker-side."""
    etype, msg = env.get("etype"), env.get("msg", "")
    if etype == "KeyError":
        raise KeyError(msg)
    raise RuntimeError(f"{etype}: {msg}")
