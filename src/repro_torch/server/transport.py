"""Transports for the work server: in-process loopback and TCP sockets.

Port of ``repro/server/transport.py``.

Both speak the same framed protocol (``protocol.frame`` + codec byte), and
both present the same two-sided API::

    transport.start(handler)      # handler: dict message -> dict reply
    conn = transport.connect()    # client side
    reply = conn.call(msg)        # one request/reply round-trip
    conn.close(); transport.stop()

**Loopback** round-trips every message through real ``encode``/``decode``
bytes (so serialization bugs cannot hide behind in-process object passing)
but stays single-threaded and allocation-cheap — the deterministic
transport the tests and ``chip_smoke.py`` drive.

**TCP** runs an asyncio server on a background thread; each connection is
served frame-by-frame in arrival order.  With the default in-loop handler,
determinism over TCP comes from the CLIENT: the serial client pool issues
one request at a time, so the server observes a total order identical to
loopback.  With ``blocking_handler=True`` the handler may BLOCK (the
sequenced-intake handler parks a message until its stamp's turn —
DESIGN.md §12), so it runs on a dedicated thread pool instead of the loop
thread: each connection still processes its own frames strictly in order
(≤1 outstanding handler call per connection), but other connections'
frames proceed while one is parked — which is exactly what lets N
concurrent volunteer connections interleave arbitrarily at the socket
while the server commits messages in intake-stamp order.

Both connection types additionally expose the raw stream half-steps
``send_bytes``/``read_reply`` that ``chaos.ChaosConnection`` composes into
faulty deliveries (torn writes, duplicated frames, lost replies); on
loopback the byte stream is emulated through a real ``FrameDecoder`` and
a reply queue, so even the in-process transport exercises stream framing.
"""
from __future__ import annotations

import asyncio
import collections
import concurrent.futures
import socket
import struct
import threading
from typing import Callable, Optional

from repro_torch.server.protocol import (DEFAULT_CODEC, FrameDecoder, ProtocolError,
                                   decode_message, encode_message,
                                   error_reply, frame)

Handler = Callable[[dict], dict]
_LEN = struct.Struct(">I")


class LoopbackConnection:
    def __init__(self, handler: Handler, codec: int):
        self._handler = handler
        self.codec = codec
        self.calls = 0
        self._decoder = FrameDecoder()
        self._replies = collections.deque()

    def call(self, msg: dict) -> dict:
        self.calls += 1
        req = decode_message(frame(encode_message(msg, self.codec))[4:])
        rep = self._handler(req)
        return decode_message(encode_message(rep, self.codec))

    # -- emulated byte stream (the chaos layer's substrate) ------------------

    def send_bytes(self, data: bytes) -> None:
        """Feed raw framed bytes exactly like a server's read loop would:
        complete frames are handled (errors become error replies, as over
        TCP), partial frames wait in the decoder for more bytes — so a
        torn write followed by close() genuinely loses the fragment."""
        for payload in self._decoder.feed(data):
            try:
                rep = self._handler(decode_message(payload))
            except ProtocolError as e:
                rep = error_reply(str(e))
            except Exception as e:  # noqa: BLE001 — mirror the TCP server
                rep = error_reply(f"{type(e).__name__}: {e}")
            self._replies.append(encode_message(rep, self.codec))

    def read_reply(self) -> dict:
        if not self._replies:
            raise ConnectionError("no reply pending on loopback stream")
        return decode_message(self._replies.popleft())

    def close(self) -> None:
        self._decoder = FrameDecoder()
        self._replies.clear()


class LoopbackTransport:
    name = "loopback"

    def __init__(self, codec: int = DEFAULT_CODEC):
        self.codec = codec
        self._handler: Optional[Handler] = None

    def start(self, handler: Handler) -> "LoopbackTransport":
        self._handler = handler
        return self

    def connect(self) -> LoopbackConnection:
        if self._handler is None:
            raise RuntimeError("transport not started")
        return LoopbackConnection(self._handler, self.codec)

    def stop(self) -> None:
        self._handler = None


class TcpConnection:
    """Blocking request/reply client over one TCP socket."""

    def __init__(self, host: str, port: int, codec: int = DEFAULT_CODEC,
                 timeout: float = 60.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.codec = codec
        self.calls = 0

    def _read_exactly(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("server closed the connection")
            buf.extend(chunk)
        return bytes(buf)

    def send_bytes(self, data: bytes) -> None:
        self._sock.sendall(data)

    def read_reply(self) -> dict:
        (n,) = _LEN.unpack(self._read_exactly(4))
        return decode_message(self._read_exactly(n))

    def call(self, msg: dict) -> dict:
        self.calls += 1
        self.send_bytes(frame(encode_message(msg, self.codec)))
        return self.read_reply()

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


class TcpTransport:
    """asyncio TCP server on a background thread.  By default the handler
    runs inside the loop thread, one frame at a time per connection; with
    ``blocking_handler=True`` it runs on a dedicated thread pool so a
    handler that PARKS (the sequenced intake waiting for a stamp's turn)
    stalls only its own connection while the loop keeps reading others —
    per-connection frame order is still strict (each frame is awaited
    before the next is dispatched)."""

    name = "tcp"

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 codec: int = DEFAULT_CODEC, blocking_handler: bool = False,
                 handler_workers: int = 64):
        self.host = host
        self.port = port                  # 0: ephemeral, resolved by start()
        self.codec = codec
        self.blocking_handler = blocking_handler
        self.handler_workers = handler_workers
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._server = None
        self._executor: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._started = threading.Event()
        self._start_error: Optional[BaseException] = None

    def start(self, handler: Handler) -> "TcpTransport":
        if self.blocking_handler:
            # one frame in flight per connection, so n_clients workers
            # suffice; 64 covers every pool size the smokes drive
            self._executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=self.handler_workers,
                thread_name_prefix="fgdo-intake")

        def handle_one(payload: bytes) -> dict:
            try:
                return handler(decode_message(payload))
            except ProtocolError as e:
                return error_reply(str(e))
            except Exception as e:  # noqa: BLE001 — a bad frame from an
                # untrusted client (well-formed but missing fields, say)
                # must produce an error REPLY, not a dead connection the
                # client only discovers at its socket timeout
                return error_reply(f"{type(e).__name__}: {e}")

        async def serve_connection(reader, writer):
            dec = FrameDecoder()
            try:
                while True:
                    data = await reader.read(65536)
                    if not data:
                        break
                    for payload in dec.feed(data):
                        if self._executor is not None:
                            rep = await asyncio.get_running_loop() \
                                .run_in_executor(self._executor,
                                                 handle_one, payload)
                        else:
                            rep = handle_one(payload)
                        writer.write(frame(encode_message(rep, self.codec)))
                    await writer.drain()
            except (ConnectionError, asyncio.IncompleteReadError):
                pass
            except ProtocolError:
                # an unframeable stream (oversized length prefix from a
                # torn write's garbage) — drop the connection cleanly;
                # the client reconnects with a fresh stream
                pass
            finally:
                try:
                    writer.close()
                except Exception:
                    pass

        async def main():
            self._server = await asyncio.start_server(
                serve_connection, self.host, self.port)
            self.port = self._server.sockets[0].getsockname()[1]
            self._started.set()
            async with self._server:
                await self._server.serve_forever()

        def run():
            self._loop = asyncio.new_event_loop()
            asyncio.set_event_loop(self._loop)
            try:
                self._loop.run_until_complete(main())
            except asyncio.CancelledError:
                pass
            except BaseException as e:      # surface bind errors to start()
                self._start_error = e
                self._started.set()
            finally:
                self._loop.close()

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="fgdo-tcp-server")
        self._thread.start()
        self._started.wait(timeout=30.0)
        if self._start_error is not None:
            raise RuntimeError(
                f"TCP transport failed to start: {self._start_error}")
        if not self._started.is_set():
            raise RuntimeError("TCP transport failed to start (timeout)")
        return self

    def connect(self) -> TcpConnection:
        return TcpConnection(self.host, self.port, self.codec)

    def stop(self) -> None:
        if self._loop is not None and self._loop.is_running():
            def shutdown():
                for task in asyncio.all_tasks(self._loop):
                    task.cancel()
            self._loop.call_soon_threadsafe(shutdown)
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        if self._executor is not None:
            self._executor.shutdown(wait=False)
            self._executor = None
        self._loop = None
        self._thread = None


def make_transport(name: str, **kwargs):
    """The transport registry: ``loopback``, ``tcp``, or ``chaos`` — the
    fault-injection decorator over either (``inner=`` names the wrapped
    transport, ``plan=`` a ``chaos.PRESETS`` name, ``FaultPlan`` doc dict,
    or ``FaultPlan`` instance)."""
    if name == "loopback":
        return LoopbackTransport(**kwargs)
    if name == "tcp":
        return TcpTransport(**kwargs)
    if name == "chaos":
        from repro_torch.server.chaos import ChaosTransport, FaultPlan, PRESETS
        inner = kwargs.pop("inner", "tcp")
        plan = kwargs.pop("plan", "degraded")
        if isinstance(plan, str):
            plan = PRESETS[plan]
        elif isinstance(plan, dict):
            plan = FaultPlan.from_doc(plan)
        return ChaosTransport(make_transport(inner, **kwargs), plan)
    raise ValueError(f"unknown transport {name!r} (loopback|tcp|chaos)")
