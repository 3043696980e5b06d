"""User-defined operations (paper section 4.1).

UDFs plug into the engine with *no engine code changes*: register a
callable under a name; queries reference it with
``{"type": "udf", "port": ..., "options": {"id": "<name>", ...}}``.
In-process transport models the paper's message queue: the UDF executor
(repro_torch.core.remote.UDFProcess) pulls requests off a queue.Queue — the
same decoupling as the paper's separate-process design, minus the wire.

UDFs receive and return torch tensors on the engine's device.  Model
UDFs (an assigned-architecture LM as a pipeline operation) arrive with
the model layer.
"""
from __future__ import annotations

import threading
from typing import Any, Callable

_REGISTRY: dict[str, Callable] = {}
_BATCHED: dict[str, Callable] = {}
_DEVICE: dict[str, Callable] = {}
_LOCK = threading.Lock()


def register_udf(name: str, fn: Callable) -> None:
    """fn(img_or_frames, **options) -> transformed array."""
    with _LOCK:
        _REGISTRY[name] = fn


def register_batched_udf(name: str, fn: Callable) -> None:
    """Group-execution variant of a UDF: ``fn(list_of_images, **options)
    -> list_of_images``.  Registering one makes the op eligible for the
    batcher backend (repro_torch.serving.batcher.UDFBatcherBackend), which the
    cost router can then pick when amortizing a group beats per-entity
    execution.  MUST be result-equivalent to the per-entity UDF of the
    same name — the router treats backends as interchangeable."""
    with _LOCK:
        _BATCHED[name] = fn


def get_batched_udf(name: str) -> Callable:
    with _LOCK:
        return _BATCHED[name]


def has_batched_udf(name: str) -> bool:
    with _LOCK:
        return name in _BATCHED


def register_device_udf(name: str, fn: Callable) -> None:
    """Device-execution variant of a UDF: ``fn(list_of_images, **options)
    -> list_of_images``, where ``fn`` runs its math on the accelerator
    (the function owns its own device placement — typically one batched
    call over the whole micro-batch).  Registering
    one makes the op eligible for the device backend
    (:class:`repro_torch.query.device_backend.DeviceBackend`), which the cost
    router can then pick when device compute + transfer beats the other
    backends.  MUST be result-equivalent to the per-entity UDF of the
    same name — the router treats backends as interchangeable.  Native
    table ops (crop/resize/...) need no registration: the device backend
    runs them over the stacked batch directly."""
    with _LOCK:
        _DEVICE[name] = fn


def get_device_udf(name: str) -> Callable:
    with _LOCK:
        return _DEVICE[name]


def has_device_udf(name: str) -> bool:
    with _LOCK:
        return name in _DEVICE


def get_udf(name: str) -> Callable:
    from repro_torch.core.pipeline import BUILTIN_UDFS
    with _LOCK:
        if name in _REGISTRY:
            return _REGISTRY[name]
    if name in BUILTIN_UDFS:
        return BUILTIN_UDFS[name]
    raise KeyError(f"UDF {name!r} not registered")


def list_udfs() -> list[str]:
    from repro_torch.core.pipeline import BUILTIN_UDFS
    with _LOCK:
        return sorted(set(_REGISTRY) | set(BUILTIN_UDFS))

