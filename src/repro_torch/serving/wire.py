"""Wire protocol for the network serving front-end.

The framing is SSE-flavored text — every frame is

    event: <name>\\n
    data: <one-line JSON object>\\n
    \\n

chosen because the stream IS server-sent events (the paper's VDMS is
client-server; per-entity results stream back as they complete), the
grammar is trivially incremental (split on the blank line), and a
transcript of frames is human-readable enough to check into
``tests/wire_golden/`` and diff on conformance failures.

Client → server frames:

- ``submit``  — ``{"rid", "query", ["tenant"], ["priority"],
  ["cache"], ["timeout_s"]}``.  ``rid`` is a client-chosen request
  token; every response frame for this query echoes it, so one
  connection can multiplex any number of concurrent queries.
- ``cancel``  — ``{"rid"}``: propagates to ``QuerySession.cancel``.
- ``ping``    — ``{}`` or ``{"rid"}``: liveness probe.

Server → client frames (all carry ``rid`` except ``pong``/``error``
for frames that never parsed far enough to have one):

- ``submitted`` — the query was admitted; streaming follows.
- ``entity``    — one entity finished one command's pipeline:
  ``{"rid", "eid", "cmd_index", "failed", "data"}`` (``data`` is the
  ndarray coding below, or null for a failed entity with no payload).
- ``complete``  — terminal: ``{"rid", "eids", "stats"}`` — ``eids``
  is the final response-dict key order, so reassembly reproduces the
  in-process dict byte-for-byte (see :func:`reassemble`).
- ``overload``  — the 429 equivalent, from admission control:
  ``{"rid", "message", "retry_after_s", ["tenant"], ["load"]}``.
- ``error``     — terminal failure: ``{"rid", "message", "etype"}``.
- ``cancelled`` — terminal: ``{"rid"}``.
- ``pong``      — ping reply.

ndarrays travel as ``{"__nd__": true, "dtype", "shape", "b64"}`` —
base64 of the C-contiguous bytes.  Decoding reproduces the array
bit-for-bit (dtype + shape + buffer), which is what lets
``chip_smoke.py`` hash wire-delivered responses against the in-process
static baseline.

Two departures from the reference codec, both by design:

- a 0-d array keeps its shape ``()``: the reference codes arrays
  through ``np.ascontiguousarray``, which returns at least one
  dimension, so its 0-d arrays decode with shape ``(1,)``;
- a ``torch.Tensor`` — on the card or not — is coded through
  :func:`repro_torch.core.boundary.to_host`, explicitly.  The
  reference's ``__array__`` branch would raise on a CUDA tensor; any
  other object with ``__array__`` still goes through ``np.asarray``.
"""
from __future__ import annotations

import base64
import json
from typing import Any, Iterator

import numpy as np
import torch

from repro_torch.core.boundary import to_host

# one frame must fit comfortably in memory; a malformed or hostile
# client streaming an unbounded data: line is cut off here
MAX_FRAME_BYTES = 64 << 20

C2S_FRAMES = ("submit", "cancel", "ping")
S2C_FRAMES = ("submitted", "entity", "complete", "overload", "error",
              "cancelled", "pong")


class WireProtocolError(ValueError):
    """A frame violated the wire grammar (unknown event, bad JSON,
    missing required field, oversized frame).  The frontend answers
    with an ``error`` frame instead of dying; the decoder raises it."""


# ------------------------------------------------------------ ndarrays
def to_jsonable(value: Any) -> Any:
    """JSON-encode a result payload: ndarrays and tensors (at any nesting
    depth in dicts/lists) become the ``__nd__`` coding; scalars pass
    through."""
    if isinstance(value, np.ndarray):
        arr = np.require(value, requirements="C")   # keeps a 0-d shape
        return {"__nd__": True, "dtype": arr.dtype.str,
                "shape": list(arr.shape),
                "b64": base64.b64encode(arr.tobytes()).decode("ascii")}
    if isinstance(value, np.generic):
        return value.item()
    if isinstance(value, dict):
        return {k: to_jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [to_jsonable(v) for v in value]
    if isinstance(value, torch.Tensor):
        # a tensor, on the card or the CPU: through the host boundary
        return to_jsonable(to_host(value))
    if hasattr(value, "__array__"):
        # other ndarray-likes: materialize on host, then code as ndarray
        return to_jsonable(np.asarray(value))
    return value


def from_jsonable(value: Any) -> Any:
    """Inverse of :func:`to_jsonable`: rebuild ndarrays bit-for-bit."""
    if isinstance(value, dict):
        if value.get("__nd__"):
            try:
                raw = base64.b64decode(value["b64"])
                arr = np.frombuffer(raw, dtype=np.dtype(value["dtype"]))
                return arr.reshape(value["shape"]).copy()
            except (KeyError, TypeError, ValueError) as e:
                raise WireProtocolError(
                    f"malformed ndarray coding: {e}") from e
        return {k: from_jsonable(v) for k, v in value.items()}
    if isinstance(value, list):
        return [from_jsonable(v) for v in value]
    return value


# ------------------------------------------------------------- framing
def encode_frame(event: str, payload: dict) -> bytes:
    """One SSE frame as bytes.  ``payload`` must already be jsonable
    (callers run :func:`to_jsonable` on result data)."""
    data = json.dumps(payload, separators=(",", ":"), sort_keys=True)
    return f"event: {event}\ndata: {data}\n\n".encode("utf-8")


class FrameDecoder:
    """Incremental frame parser: feed arbitrary byte chunks, iterate
    complete ``(event, payload)`` frames.  Any chunking of the stream
    decodes to the same frame sequence (the Hypothesis property in
    ``tests/test_torch_frontend.py``); a grammar violation raises
    :class:`WireProtocolError` and poisons the decoder (the frontend
    drops the connection — there is no way to resynchronize a framed
    text stream after a malformed frame)."""

    def __init__(self, *, known_events: tuple = C2S_FRAMES + S2C_FRAMES):
        self._buf = bytearray()
        self._known = known_events
        self._dead = False

    def feed(self, chunk: bytes) -> Iterator[tuple[str, dict]]:
        if self._dead:
            raise WireProtocolError("decoder poisoned by earlier error")
        self._buf.extend(chunk)
        if len(self._buf) > MAX_FRAME_BYTES:
            self._dead = True
            raise WireProtocolError(
                f"frame exceeds MAX_FRAME_BYTES={MAX_FRAME_BYTES}")
        while True:
            idx = self._buf.find(b"\n\n")
            if idx < 0:
                return
            raw = bytes(self._buf[:idx])
            del self._buf[:idx + 2]
            try:
                yield self._parse(raw)
            except WireProtocolError:
                self._dead = True
                raise

    def _parse(self, raw: bytes) -> tuple[str, dict]:
        try:
            text = raw.decode("utf-8")
        except UnicodeDecodeError as e:
            raise WireProtocolError(f"frame is not utf-8: {e}") from e
        lines = text.split("\n")
        if len(lines) != 2 or not lines[0].startswith("event: ") \
                or not lines[1].startswith("data: "):
            raise WireProtocolError(
                f"malformed frame (want 'event: .../data: ...'): "
                f"{text[:120]!r}")
        event = lines[0][len("event: "):]
        if event not in self._known:
            raise WireProtocolError(f"unknown frame event {event!r}")
        try:
            payload = json.loads(lines[1][len("data: "):])
        except json.JSONDecodeError as e:
            raise WireProtocolError(f"frame data is not JSON: {e}") from e
        if not isinstance(payload, dict):
            raise WireProtocolError(
                f"frame data must be a JSON object, got "
                f"{type(payload).__name__}")
        return event, payload


# --------------------------------------------------------- reassembly
def reassemble(frames: list[tuple[str, dict]]) -> dict:
    """Rebuild the in-process response dict from one query's streamed
    frames (any order of ``entity`` frames + one ``complete``).

    The in-process session keeps the *latest* state per (command, eid)
    and assembles the response in (command order x matched-eid order);
    on the wire that means: for each eid the ``entity`` frame with the
    highest ``cmd_index`` wins (a later command's pipeline superseded
    the earlier one's output for that eid), and the ``complete``
    frame's ``eids`` list IS the final key order.  The Hypothesis
    property drives this against the live session for arbitrary frame
    interleavings."""
    best: dict[str, tuple[int, Any]] = {}
    complete = None
    for event, payload in frames:
        if event == "entity":
            eid, ci = payload["eid"], payload["cmd_index"]
            if eid not in best or ci >= best[eid][0]:
                best[eid] = (ci, from_jsonable(payload.get("data")))
        elif event == "complete":
            complete = payload
    if complete is None:
        raise WireProtocolError("no complete frame to reassemble from")
    entities = {}
    for eid in complete["eids"]:
        if eid in best:
            entities[eid] = best[eid][1]
    return {"entities": entities, "stats": from_jsonable(complete["stats"])}
