"""Versioned wire protocol for the FGDO work server (DESIGN.md §9).

Port of ``repro/server/protocol.py``, byte for byte: a frame either package
writes, the other reads.

Frames.  Every message travels as a length-prefixed frame::

    [4-byte big-endian payload length][1-byte codec][codec-encoded body]

The codec byte makes the framing self-describing (a JSON client can talk
to a msgpack-preferring server and vice versa), and the body always
carries ``"v": PROTOCOL_VERSION`` — a mismatched peer gets a clean
``ProtocolError`` instead of a misparsed field.  msgpack is used when the
``msgpack`` package is importable, JSON otherwise (both round-trip float64
exactly, which the bit-identical resume contract relies on: fitness values
and points cross the wire and must come back the same bits).

Message kinds (client → server)::

    register        {host_id, now}
    request_work    {host_id, now}
    report_result   {host_id, search, wu, y, now}
    heartbeat       {host_id, now}
    shutdown        {now}
    status          {}                     # read-only, never mutates
    subscribe_stats {since}                # read-only cursor long-poll on
                                           # the metrics ring (§13); like
                                           # status: unstamped, uncounted,
                                           # never logged

and replies (server → client)::

    registered     {host_id}
    work           {search, wu, phase, point, alpha, validates, deadline}
    no_work        {retry_after, done}
    ack            {done, iteration, best}
    status         {…summary…}             # incl. ``cache`` counters (hits,
                                           # misses, lanes_saved, store_size)
                                           # when an eval cache is attached,
                                           # else ``cache: null`` (§10);
                                           # service pressure (lease depth,
                                           # intake queue) rides here too
    stats          {snapshots, cursor, interval, stream_v}
                                           # every hub snapshot with
                                           # seq > since, oldest first (§13)
    error          {error}

``wu`` ids are the engine's tickets (unique per search); ``validates``
carries the candidate ticket a quorum replica re-checks — the replica tag
that lets a client know it is voting, not exploring.  ``deadline`` is the
lease expiry: a result reported after it is still assimilated (the
engine's phase-stale filter is the semantic gate) but the server stops
counting on the lease.
"""
from __future__ import annotations

import json
import struct
from typing import Iterator, Optional

import numpy as np

try:                                  # the container ships msgpack; the
    import msgpack                    # JSON fallback keeps the protocol
except ImportError:                   # importable without it
    msgpack = None

PROTOCOL_VERSION = 1
CODEC_JSON, CODEC_MSGPACK = 1, 2
DEFAULT_CODEC = CODEC_MSGPACK if msgpack is not None else CODEC_JSON

_LEN = struct.Struct(">I")
MAX_FRAME = 1 << 24                   # 16 MiB — no legitimate message is close


class ProtocolError(Exception):
    pass


def _py(x):
    """Numpy → plain python, recursively (codec-agnostic bodies)."""
    if isinstance(x, np.ndarray):
        return [_py(v) for v in x.tolist()]
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, dict):
        return {k: _py(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_py(v) for v in x]
    return x


def encode_message(msg: dict, codec: int = DEFAULT_CODEC) -> bytes:
    body = dict(_py(msg))
    body["v"] = PROTOCOL_VERSION
    if codec == CODEC_MSGPACK:
        if msgpack is None:
            raise ProtocolError("msgpack codec requested but not installed")
        raw = msgpack.packb(body, use_bin_type=True)
    elif codec == CODEC_JSON:
        raw = json.dumps(body).encode("utf-8")
    else:
        raise ProtocolError(f"unknown codec {codec}")
    return bytes([codec]) + raw


def decode_message(payload: bytes) -> dict:
    if not payload:
        raise ProtocolError("empty frame")
    codec, raw = payload[0], payload[1:]
    if codec == CODEC_MSGPACK:
        if msgpack is None:
            raise ProtocolError("peer sent msgpack but it is not installed")
        body = msgpack.unpackb(raw, raw=False)
    elif codec == CODEC_JSON:
        body = json.loads(raw.decode("utf-8"))
    else:
        raise ProtocolError(f"unknown codec byte {codec}")
    if body.get("v") != PROTOCOL_VERSION:
        raise ProtocolError(
            f"protocol version mismatch: peer={body.get('v')} "
            f"ours={PROTOCOL_VERSION}")
    return body


def frame(payload: bytes) -> bytes:
    if len(payload) > MAX_FRAME:
        raise ProtocolError(f"frame of {len(payload)} bytes exceeds cap")
    return _LEN.pack(len(payload)) + payload


class FrameDecoder:
    """Incremental frame splitter for stream transports: feed() raw bytes
    as they arrive, iterate complete payloads."""

    def __init__(self):
        self._buf = bytearray()

    def feed(self, data: bytes) -> Iterator[bytes]:
        self._buf.extend(data)
        while True:
            if len(self._buf) < _LEN.size:
                return
            (n,) = _LEN.unpack_from(self._buf)
            if n > MAX_FRAME:
                raise ProtocolError(f"frame of {n} bytes exceeds cap")
            if len(self._buf) < _LEN.size + n:
                return
            payload = bytes(self._buf[_LEN.size:_LEN.size + n])
            del self._buf[:_LEN.size + n]
            yield payload


# -- message builders (clients) ----------------------------------------------
#
# ``cs`` is the per-host client sequence number — the idempotency key
# (host_id, cs) the server dedups retried/duplicated deliveries on, echoed
# back in the reply so a client can match replies to requests on a stream
# that may carry duplicates.  ``seq`` is the global intake stamp a
# concurrent pool's coordinator assigns at release time; the server's
# sequenced intake handles messages in stamp order regardless of arrival
# interleaving.  Both are optional — a bare client (or the serial pool's
# pre-PR-8 wire traffic) stays valid.

def _stamp(msg: dict, cs: Optional[int], seq: Optional[int]) -> dict:
    if cs is not None:
        msg["cs"] = int(cs)
    if seq is not None:
        msg["intake_seq"] = int(seq)
    return msg


def register(host_id: int, now: float, cs: Optional[int] = None,
             seq: Optional[int] = None) -> dict:
    return _stamp({"kind": "register", "host_id": int(host_id),
                   "now": float(now)}, cs, seq)


def request_work(host_id: int, now: float, cs: Optional[int] = None,
                 seq: Optional[int] = None) -> dict:
    return _stamp({"kind": "request_work", "host_id": int(host_id),
                   "now": float(now)}, cs, seq)


def report_result(host_id: int, search: int, wu: int, y: float,
                  now: float, cs: Optional[int] = None,
                  seq: Optional[int] = None) -> dict:
    return _stamp({"kind": "report_result", "host_id": int(host_id),
                   "search": int(search), "wu": int(wu), "y": float(y),
                   "now": float(now)}, cs, seq)


def heartbeat(host_id: int, now: float, cs: Optional[int] = None,
              seq: Optional[int] = None) -> dict:
    return _stamp({"kind": "heartbeat", "host_id": int(host_id),
                   "now": float(now)}, cs, seq)


def shutdown(now: float) -> dict:
    return {"kind": "shutdown", "now": float(now)}


def status() -> dict:
    return {"kind": "status"}


def subscribe_stats(since: int = -1, from_store: bool = False) -> dict:
    """Long-poll the server's metrics ring for snapshots with
    ``seq > since``.  Deliberately stamp-free, like ``status``: a
    monitoring poll must never consume an intake stamp or a (host, cs)
    slot, so it can interleave with the applied stream at any rate
    without perturbing it.  ``from_store=True`` asks the server to
    backfill snapshots the ring already dropped from its retention
    store, when one is attached (§14) — the key rides the wire only
    when set, so old servers never see it."""
    msg = {"kind": "subscribe_stats", "since": int(since)}
    if from_store:
        msg["from_store"] = True
    return msg


# -- reply builders (server) --------------------------------------------------

def work_reply(search: int, wu: int, phase: int, point, alpha: float,
               validates: Optional[int], deadline: float) -> dict:
    return {"kind": "work", "search": int(search), "wu": int(wu),
            "phase": int(phase), "point": [float(v) for v in point],
            "alpha": float(alpha),
            "validates": None if validates is None else int(validates),
            "deadline": float(deadline)}


def no_work_reply(retry_after: float, done: bool) -> dict:
    return {"kind": "no_work", "retry_after": float(retry_after),
            "done": bool(done)}


def ack_reply(done: bool, iteration: int, best: float) -> dict:
    return {"kind": "ack", "done": bool(done), "iteration": int(iteration),
            "best": float(best)}


def stats_reply(snapshots, cursor: int, interval: float,
                stream_v: int, dropped: int = 0) -> dict:
    # ``dropped``: snapshots the caller's cursor missed because the ring
    # (minus any store backfill) already evicted them — an explicit gap
    # signal instead of silently skipped seqs (§14 satellite)
    return {"kind": "stats", "snapshots": list(snapshots),
            "cursor": int(cursor), "interval": float(interval),
            "stream_v": int(stream_v), "dropped": int(dropped)}


def error_reply(msg: str) -> dict:
    return {"kind": "error", "error": str(msg)}
