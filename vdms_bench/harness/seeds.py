"""Independent random streams from one ``--seed``: each use (weights,
faces, traffic, the correctness sample) draws from its own stream, so
that a change in how one is drawn moves no other."""
from __future__ import annotations

import hashlib


def stream(seed: int, name: str) -> int:
    """A 63-bit seed for the stream ``name`` of run seed ``seed`` (any
    whole number)."""
    digest = hashlib.sha256(f"{int(seed)}/{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1
