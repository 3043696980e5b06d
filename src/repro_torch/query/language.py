"""VDMS-style JSON query language (paper Figs 1, 3, 5, 8).

A query is a list of command objects:

  [{"AddImage":  {"properties": {...}, "data": <array>,
                  "operations": [...]}},
   {"FindImage": {"constraints": {"category": ["==", "celebrity"],
                                  "age": [">=", 21, "<=", 40]},
                  "operations": [{"type": "resize", "width": 400,
                                  "height": 500},
                                 {"type": "remote",
                                  "url": "http://.../facedetect",
                                  "options": {"id": "facedetect_box"}},
                                 {"type": "threshold", "value": 0.4}]}}]

AddVideo / FindVideo are the video twins.  ``parse_query`` validates and
normalizes into Command objects the engine executes.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.core.pipeline import Operation, parse_operations

COMMANDS = ("AddImage", "AddVideo", "FindImage", "FindVideo")


@dataclasses.dataclass
class Command:
    verb: str                      # Add | Find
    kind: str                      # image | video
    properties: dict
    constraints: dict
    operations: list
    data: Any = None
    limit: int | None = None
    name: str = ""                 # original command name (plan display)
    eid: str | None = None         # Add only: caller-assigned entity id
                                   # (cluster ingest; None = store-assigned)


def parse_query(q: list[dict]) -> list[Command]:
    if isinstance(q, dict):
        q = [q]
    cmds = []
    for item in q:
        if len(item) != 1:
            raise ValueError("each query entry must hold exactly one command")
        (name, body), = item.items()
        if name not in COMMANDS:
            raise ValueError(f"unknown command {name!r}; expected {COMMANDS}")
        verb = "add" if name.startswith("Add") else "find"
        kind = "image" if name.endswith("Image") else "video"
        cmds.append(Command(
            verb=verb,
            kind=kind,
            properties=dict(body.get("properties", {})),
            constraints=dict(body.get("constraints", {})),
            operations=parse_operations(body.get("operations", [])),
            data=body.get("data"),
            limit=body.get("limit"),
            name=name,
            eid=body.get("eid") if verb == "add" else None,
        ))
    return cmds
