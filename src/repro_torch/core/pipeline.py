"""Operation pipeline representation + native-chain fusion.

Beyond-paper optimization (ARCHITECTURE.md, ``fuse_native``): VDMS-Async
executes pipeline operations one at a time; here, the event loop hands a
maximal run of native ops to one worker call (:func:`run_native_chain`).
PyTorch runs eagerly, so the run is its ops one after another, each
launching its own work (a compiled or CUDA-graph variant is later work).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any

import torch

from repro_torch.visual import facedetect
from repro_torch.visual.ops import NATIVE_OPS, apply_native_op

# compound vision UDFs shipped with the system (run locally when an op is
# tagged native, or on a remote server / UDF process otherwise)
BUILTIN_UDFS = {
    "facedetect_box": facedetect.facedetect_box,
    "facedetect_mask": facedetect.facedetect_mask,
    "manipulation": facedetect.facedetect_manipulation,
    "activityrecognition": facedetect.activity_recognition,
}


@dataclasses.dataclass(frozen=True)
class Operation:
    name: str
    params: tuple   # sorted tuple of (key, value) pairs — hashable
    where: str      # "native" | "udf" | "remote"
    url: str = ""   # remote endpoint (plug-and-play, paper section 4.2)
    port: int = 0   # UDF message-queue port (paper section 4.1)

    @property
    def kwargs(self) -> dict:
        return dict(self.params)

    @property
    def is_native(self) -> bool:
        return self.where == "native"


def make_op(name: str, params: dict | None = None, where: str = "native",
            url: str = "", port: int = 0) -> Operation:
    params = params or {}
    return Operation(name=name, params=tuple(sorted(params.items())),
                     where=where, url=url, port=port)


def parse_operations(op_list: list[dict]) -> list[Operation]:
    """Parse the query JSON operations array (paper Figs 3/5/8).

    Native entry:  {"type": "resize", "width": 400, "height": 500}
    UDF entry:     {"type": "udf", "port": 5555, "options": {"id": "blur", ...}}
    Remote entry:  {"type": "remote", "url": "http://...", "options": {...}}
    """
    out = []
    for entry in op_list:
        e = dict(entry)
        typ = e.pop("type")
        if typ == "udf":
            opts = dict(e.pop("options", {}))
            name = opts.pop("id")
            out.append(make_op(name, opts, where="udf", port=e.get("port", 0)))
        elif typ == "remote":
            opts = dict(e.pop("options", {}))
            name = opts.pop("id")
            out.append(make_op(name, opts, where="remote", url=e.get("url", "")))
        else:
            out.append(make_op(typ, e, where="native"))
    return out


def run_op(op: Operation, img):
    """Execute one op locally (native table first, then builtin UDFs).
    Video entities (T,H,W,C) are processed frame-by-frame — ops stay
    image-level like the paper's OpenCV operations."""
    if getattr(img, "ndim", 3) == 4:
        return torch.stack([run_op(op, img[t]) for t in range(img.shape[0])])
    if op.name in NATIVE_OPS:
        return apply_native_op(op.name, img, op.kwargs)
    if op.name in BUILTIN_UDFS:
        return BUILTIN_UDFS[op.name](img, **op.kwargs)
    from repro_torch.core.udf import get_udf
    return get_udf(op.name)(img, **op.kwargs)


# ------------------------------------------------------------- fusion
def run_native_chain(ops: list[Operation], img):
    """Execute a run of native ops in one call (video frame by frame)."""
    for op in ops:
        img = run_op(op, img)
    return img
