"""Network serving front-end: the engine's door to the wire.

``WireFrontend`` puts a :class:`~repro_torch.core.engine.VDMSAsyncEngine`
— or the :class:`~repro_torch.cluster.engine.ShardedEngine` (both expose
the same ``submit``/future surface) — behind a threaded socket server
speaking the SSE-flavored protocol in :mod:`repro_torch.serving.wire`:

- ``submit`` returns immediately: the client's ``rid`` is the query
  token, a ``submitted`` frame acknowledges admission, and per-entity
  results stream back as ``entity`` frames by bridging the session
  API's ``on_entity`` callback (the frames are *pushed from the
  event-loop threads that complete the entities* — no polling);
- :class:`~repro_torch.query.admission.OverloadError` maps to an
  ``overload`` frame — the 429 equivalent — carrying the admission
  controller's ``retry_after_s`` estimate, the load snapshot, and the
  tenant when a per-tenant quota (admission v2) did the rejecting;
- cancellation (a ``cancel`` frame), client timeouts (``timeout_s``
  riding the submit frame into the engine's retry-deadline budget)
  and **disconnects** all propagate to ``QuerySession.cancel``: when a
  connection drops, every one of its in-flight queries is cancelled,
  so a dropped client never leaks admission slots (the chaos suite in
  ``tests/test_torch_frontend.py`` storms this).

One connection multiplexes any number of concurrent queries; frames
interleave across queries but stay ordered within one (``submitted``
→ ``entity``* → terminal), which is what lets
:func:`repro_torch.serving.wire.reassemble` rebuild the in-process
response dict byte-for-byte (hash-gated against the static baseline by
``chip_smoke.py``'s phase 9 on the card).  The engine's responses and
streamed entities are host arrays already (its host boundary,
:mod:`repro_torch.core.boundary`), so nothing here waits on the card.

``WireClient`` is the reference client: ``execute()`` for blocking
calls, ``submit()`` for a future-like handle with streamed frames
attached (the conformance transcripts are recorded through it).

Everything here is OFF by default — nothing constructs a frontend
unless asked, and an engine fronted by one behaves identically for
in-process callers.
"""
from __future__ import annotations

import queue
import socket
import struct
import threading
from concurrent.futures import CancelledError
from typing import Any, Optional

from repro_torch.query.admission import OverloadError
from repro_torch.serving.wire import (C2S_FRAMES, FrameDecoder,
                                      WireProtocolError, encode_frame,
                                      from_jsonable, reassemble, to_jsonable)

_RECV_CHUNK = 1 << 16


def _overload_payload(rid: Optional[str], exc: OverloadError) -> dict:
    payload = {"rid": rid, "message": str(exc),
               "retry_after_s": exc.retry_after_s}
    if exc.tenant:
        payload["tenant"] = exc.tenant
    if exc.load:
        payload["load"] = to_jsonable(exc.load)
    return payload


class _Conn:
    """One accepted connection: a reader thread (parse + dispatch
    frames), a writer thread (drain the outbound FIFO), and the
    per-request gate that holds streamed frames back until the
    ``submitted`` acknowledgment is on the wire — phase-0 ``on_entity``
    callbacks fire *inside* ``engine.submit()`` (instant cache hits,
    empty phases), and without the gate those entity frames would
    precede their own submit ack."""

    def __init__(self, frontend: "WireFrontend", sock: socket.socket,
                 peer):
        self._frontend = frontend
        self._sock = sock
        self.peer = peer
        self._out: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self._futures: dict[str, Any] = {}     # guarded-by: _lock
        self._gates: dict[str, list] = {}      # guarded-by: _lock
        self._closed = False                   # guarded-by: _lock
        self._writer = threading.Thread(
            target=self._write_loop, name=f"wire-writer-{peer}",
            daemon=True)
        self._reader = threading.Thread(
            target=self._read_loop, name=f"wire-reader-{peer}",
            daemon=True)

    def start(self):
        self._writer.start()
        self._reader.start()

    # ------------------------------------------------------------ output
    def _send(self, rid: Optional[str], event: str, payload: dict):
        """Enqueue one frame, honoring ``rid``'s gate if it is closed
        (buffering until the submit ack went out)."""
        frame = encode_frame(event, payload)
        with self._lock:
            if self._closed:
                return
            gate = self._gates.get(rid) if rid is not None else None
            if gate is not None:
                gate.append(frame)
                return
            self._out.put(frame)

    def _open_gate(self, rid: str, ack_frame: bytes | None):
        """Atomically emit the submit ack, flush the frames the gate
        buffered while ``engine.submit()`` ran, and stream directly
        from now on."""
        with self._lock:
            buffered = self._gates.pop(rid, [])
            if self._closed:
                return
            if ack_frame is not None:
                self._out.put(ack_frame)
            for frame in buffered:
                self._out.put(frame)

    def _write_loop(self):
        while True:
            frame = self._out.get()
            if frame is None:
                return
            try:
                self._sock.sendall(frame)
            except OSError:
                return                     # reader notices and cleans up

    # ------------------------------------------------------------- input
    def _read_loop(self):
        decoder = FrameDecoder(known_events=C2S_FRAMES)
        try:
            while True:
                chunk = self._sock.recv(_RECV_CHUNK)
                if not chunk:
                    return
                for event, payload in decoder.feed(chunk):
                    self._dispatch(event, payload)
        except WireProtocolError as e:
            # a framing violation is unrecoverable on a framed stream:
            # answer with an error frame (best effort), then drop the
            # connection — which cancels this client's queries below
            self._send(None, "error",
                       {"rid": None, "message": str(e),
                        "etype": "WireProtocolError"})
        except OSError:
            pass
        finally:
            self.close()

    def _dispatch(self, event: str, payload: dict):
        if event == "ping":
            self._send(None, "pong", {"rid": payload.get("rid")})
        elif event == "cancel":
            rid = payload.get("rid")
            with self._lock:
                fut = self._futures.get(rid)
            if fut is not None:
                fut.cancel()       # terminal frame flows via done-callback
        elif event == "submit":
            self._handle_submit(payload)

    def _handle_submit(self, payload: dict):
        rid = payload.get("rid")
        if not isinstance(rid, str) or not rid:
            self._send(None, "error",
                       {"rid": None, "etype": "ValueError",
                        "message": "submit frame needs a non-empty "
                                   "string rid"})
            return
        if "query" not in payload:
            self._send(rid, "error",
                       {"rid": rid, "etype": "ValueError",
                        "message": "submit frame needs a query"})
            return
        with self._lock:
            if rid in self._futures or rid in self._gates:
                dup = True
            else:
                dup = False
                self._gates[rid] = []       # gate closed: buffer streams
        if dup:
            self._send(rid, "error",
                       {"rid": rid, "etype": "ValueError",
                        "message": f"rid {rid!r} is already in flight "
                                   f"on this connection"})
            return
        try:
            fut = self._frontend.engine.submit(
                payload["query"],
                on_entity=lambda ent, rid=rid: self._stream_entity(rid, ent),
                cache=payload.get("cache", True),
                priority=payload.get("priority", 0),
                timeout_s=payload.get("timeout_s"),
                tenant=payload.get("tenant", ""))
        except OverloadError as e:
            with self._lock:
                self._gates.pop(rid, None)   # nothing launched or queued
            self._send(rid, "overload", _overload_payload(rid, e))
            return
        except Exception as e:  # noqa: BLE001 — parse/validation errors
            with self._lock:
                self._gates.pop(rid, None)
            self._send(rid, "error",
                       {"rid": rid, "etype": type(e).__name__,
                        "message": str(e)})
            return
        with self._lock:
            if self._closed:
                # disconnect raced the submit: nobody will read the
                # stream — release the engine work immediately
                fut.cancel()
                return
            self._futures[rid] = fut
        self._open_gate(rid, encode_frame("submitted", {"rid": rid}))
        fut.add_done_callback(
            lambda f, rid=rid: self._query_done(rid, f))

    # -------------------------------------------------------- engine side
    def _stream_entity(self, rid: str, ent):
        # runs on event-loop threads (and, for instant entities, on the
        # submitting reader thread while the gate is still closed)
        self._send(rid, "entity",
                   {"rid": rid, "eid": ent.eid, "cmd_index": ent.cmd_index,
                    "failed": ent.failed, "data": to_jsonable(ent.data)})

    def _query_done(self, rid: str, fut):
        with self._lock:
            self._futures.pop(rid, None)
        state, value = fut.outcome()
        if state == "done":
            self._send(rid, "complete",
                       {"rid": rid, "eids": list(value["entities"]),
                        "stats": to_jsonable(value["stats"])})
        elif state == "cancelled":
            self._send(rid, "cancelled", {"rid": rid})
        elif isinstance(value, OverloadError):
            self._send(rid, "overload", _overload_payload(rid, value))
        else:
            self._send(rid, "error",
                       {"rid": rid, "etype": type(value).__name__,
                        "message": str(value)})

    # ------------------------------------------------------------ cleanup
    def close(self):
        """Tear the connection down: cancel every in-flight query this
        client owns (disconnect → ``QuerySession.cancel`` → admission
        ``drop_query``: no leaked slots), stop the writer, close the
        socket."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            futures = list(self._futures.values())
            self._futures.clear()
            self._gates.clear()
        for fut in futures:
            try:
                fut.cancel()
            except Exception:  # noqa: BLE001 — engine may be shutting down
                pass
        self._out.put(None)
        # let the writer flush what is already queued — the goodbye
        # error frame for a grammar violation must reach the client
        # before the socket dies under it (bounded: a client that has
        # stopped reading only delays the close, never wedges it)
        if threading.current_thread() is not self._writer \
                and self._writer.is_alive():
            self._writer.join(timeout=2.0)
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
        self._frontend._conn_closed(self)


class WireFrontend:
    """Threaded socket server over an engine's session API.

    ``engine`` is anything with the ``submit(query, *, on_entity,
    cache, priority, timeout_s, tenant) -> future`` surface — the
    single-process :class:`~repro_torch.core.engine.VDMSAsyncEngine` and the
    :class:`~repro_torch.cluster.engine.ShardedEngine` both qualify.  The
    frontend owns no engine lifecycle: closing it cancels the wire
    clients' queries but leaves the engine running (in-process callers
    are unaffected — the wire is an additional door, not a wrapper).

    Usage::

        front = WireFrontend(engine).start()
        ...
        client = WireClient(front.address)
        result = client.execute([{"FindImage": {...}}])
        front.close()
    """

    def __init__(self, engine, *, host: str = "127.0.0.1", port: int = 0,
                 backlog: int = 128):
        self.engine = engine
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(backlog)
        self.address: tuple[str, int] = self._sock.getsockname()
        self._lock = threading.Lock()
        self._conns: set[_Conn] = set()        # guarded-by: _lock
        self._closed = False                   # guarded-by: _lock
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="wire-accept", daemon=True)

    def start(self) -> "WireFrontend":
        self._accept_thread.start()
        return self

    def _accept_loop(self):
        while True:
            try:
                sock, peer = self._sock.accept()
            except OSError:
                return                          # listener closed
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = _Conn(self, sock, peer)
            with self._lock:
                if self._closed:
                    sock.close()
                    return
                self._conns.add(conn)
            conn.start()

    def _conn_closed(self, conn: _Conn):
        with self._lock:
            self._conns.discard(conn)

    def connections(self) -> int:
        with self._lock:
            return len(self._conns)

    def close(self):
        """Stop accepting, drop every connection (cancelling their
        in-flight queries).  Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            conns = list(self._conns)
        try:
            # close() alone does not wake a thread blocked in accept()
            # on Linux — shutdown the listener first so the accept loop
            # exits instead of leaking past the join below
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        for conn in conns:
            conn.close()
        if self._accept_thread.is_alive():
            self._accept_thread.join(timeout=5)

    def __enter__(self) -> "WireFrontend":
        return self.start() if not self._accept_thread.is_alive() else self

    def __exit__(self, *exc):
        self.close()


# ============================================================== client
class _WireFuture:
    """Client-side handle to one wire query: pulls this rid's frames
    off the demux queue on demand.  ``frames`` accumulates every frame
    seen (the conformance transcripts are recorded from it)."""

    def __init__(self, client: "WireClient", rid: str):
        self._client = client
        self.rid = rid
        self._q: queue.Queue = queue.Queue()
        self.frames: list[tuple[str, dict]] = []
        self._terminal: tuple[str, dict] | None = None

    # fed by the client reader thread
    def _push(self, event: str, payload: dict):
        self._q.put((event, payload))

    def _pull(self, timeout: Optional[float]) -> tuple[str, dict]:
        try:
            event, payload = self._q.get(timeout=timeout)
        except queue.Empty:
            raise TimeoutError(
                f"wire query {self.rid} timed out waiting for frames")
        self.frames.append((event, payload))
        if event in ("complete", "overload", "error", "cancelled"):
            self._terminal = (event, payload)
        return event, payload

    def wait_terminal(self, timeout: Optional[float] = None) \
            -> tuple[str, dict]:
        """Drain frames until this query's terminal frame; returns it.
        ``timeout`` bounds each inter-frame gap (a stream that stalls
        longer than that raises ``TimeoutError``)."""
        while self._terminal is None:
            self._pull(timeout)
        return self._terminal

    def result(self, timeout: Optional[float] = None) -> dict:
        """Block for the reassembled response dict — byte-identical to
        the in-process ``future.result()`` (modulo ``duration_s``).
        Raises the same exception types the in-process API does:
        :class:`OverloadError` (with ``retry_after_s``/``tenant``
        rebuilt from the 429 frame), ``CancelledError``, or a
        ``RuntimeError`` for server-side failures."""
        event, payload = self.wait_terminal(timeout)
        if event == "complete":
            return reassemble(self.frames)
        if event == "overload":
            raise OverloadError(
                payload["message"],
                retry_after_s=payload["retry_after_s"],
                load=from_jsonable(payload.get("load")) or {},
                tenant=payload.get("tenant"))
        if event == "cancelled":
            raise CancelledError(f"wire query {self.rid} cancelled")
        raise RuntimeError(
            f"wire query {self.rid} failed: [{payload.get('etype')}] "
            f"{payload.get('message')}")

    def cancel(self):
        self._client._send("cancel", {"rid": self.rid})


class WireClient:
    """Reference client for the wire protocol (and the harness the
    conformance/chaos tests drive).  One socket, one reader thread
    demuxing frames by ``rid`` to per-query :class:`_WireFuture`\\ s."""

    def __init__(self, address: tuple[str, int], *,
                 connect_timeout: float = 5.0):
        self._sock = socket.create_connection(address,
                                              timeout=connect_timeout)
        self._sock.settimeout(None)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._lock = threading.Lock()
        # writes get their own lock: sendall() can block indefinitely on
        # a full send buffer (peer not reading), and holding the state
        # lock across it would wedge close()/drop() behind a stalled peer
        self._io_lock = threading.Lock()
        self._futures: dict[str, _WireFuture] = {}   # guarded-by: _lock
        self._orphans: queue.Queue = queue.Queue()   # pong / rid-less error
        self._rid_seq = 0                            # guarded-by: _lock
        self._closed = False                         # guarded-by: _lock
        self.disconnected = threading.Event()
        self._reader = threading.Thread(target=self._read_loop,
                                        name="wire-client-reader",
                                        daemon=True)
        self._reader.start()

    # ------------------------------------------------------------ plumbing
    def _send(self, event: str, payload: dict):
        frame = encode_frame(event, payload)
        with self._lock:
            if self._closed:
                raise OSError("wire client is closed")
        with self._io_lock:
            # _io_lock guards no state — it only serializes writers
            # analysis: ok(blocking-under-lock) — IO-only lock, held for nothing else
            self._sock.sendall(frame)

    def _read_loop(self):
        decoder = FrameDecoder()
        try:
            while True:
                chunk = self._sock.recv(_RECV_CHUNK)
                if not chunk:
                    break
                for event, payload in decoder.feed(chunk):
                    rid = payload.get("rid")
                    with self._lock:
                        fut = self._futures.get(rid)
                    if fut is not None:
                        fut._push(event, payload)
                    else:
                        self._orphans.put((event, payload))
        except (OSError, WireProtocolError):
            pass
        finally:
            self.disconnected.set()
            # wake every waiter: the server is gone, their frames will
            # never arrive — surface it as a terminal error frame
            with self._lock:
                futures = list(self._futures.values())
            for fut in futures:
                fut._push("error", {"rid": fut.rid,
                                    "etype": "ConnectionError",
                                    "message": "connection closed"})

    def _next_rid(self) -> str:
        with self._lock:
            self._rid_seq += 1
            return f"r{self._rid_seq}"

    # ------------------------------------------------------------- public
    def submit(self, query, *, tenant: str = "", priority: int = 0,
               cache: bool = True, timeout_s: Optional[float] = None,
               rid: Optional[str] = None) -> _WireFuture:
        rid = rid if rid is not None else self._next_rid()
        fut = _WireFuture(self, rid)
        with self._lock:
            self._futures[rid] = fut
        payload: dict = {"rid": rid, "query": query}
        if tenant:
            payload["tenant"] = tenant
        if priority:
            payload["priority"] = priority
        if not cache:
            payload["cache"] = False
        if timeout_s is not None:
            payload["timeout_s"] = timeout_s
        self._send("submit", payload)
        return fut

    def execute(self, query, timeout: Optional[float] = None,
                **kw) -> dict:
        return self.submit(query, **kw).result(timeout)

    def ping(self, timeout: float = 5.0) -> bool:
        self._send("ping", {})
        try:
            event, _ = self._orphans.get(timeout=timeout)
        except queue.Empty:
            return False
        return event == "pong"

    def send_raw(self, data: bytes):
        """Ship raw bytes down the socket — the malformed-frame
        conformance tests poke the server's grammar with this."""
        with self._io_lock:
            # _io_lock guards no state — it only serializes writers
            # analysis: ok(blocking-under-lock) — IO-only lock, held for nothing else
            self._sock.sendall(data)

    def next_orphan(self, timeout: float = 5.0) -> tuple[str, dict]:
        """Next frame that matched no in-flight rid (pong, rid-less
        error) — the malformed-frame tests read rejections here."""
        return self._orphans.get(timeout=timeout)

    def close(self):
        with self._lock:
            if self._closed:
                return
            self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
        self._reader.join(timeout=5)

    def drop(self):
        """Simulate an abrupt client death (no goodbye): hard-close the
        socket so the server sees a disconnect mid-stream.  The chaos
        tests use this to prove disconnect → cancel → no leaked
        admission slots."""
        with self._lock:
            self._closed = True
        try:
            # SO_LINGER(on, 0): close sends RST instead of FIN — the
            # server sees a genuine mid-stream failure, not a shutdown
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                                  struct.pack("ii", 1, 0))
        except OSError:
            pass
        self._sock.close()

    def __enter__(self) -> "WireClient":
        return self

    def __exit__(self, *exc):
        self.close()
