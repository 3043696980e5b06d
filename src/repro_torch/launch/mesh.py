"""Meshes over the ranks of the default process group.

Single pod: 16 x 16 (256 ranks) -> axes (data, model).
Multi-pod:  2 x 16 x 16 (512 ranks) -> axes (pod, data, model); the pod
axis is the outer data-parallel axis.

The port's "local devices" are the ranks of the default process group,
or one rank when none is initialised.  These are functions, and nothing
here initialises a process group at import: a launcher started by
``torchrun`` enters :func:`process_group_from_env` itself.
"""
from __future__ import annotations

import contextlib
import math
import os

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import Mesh


def world_size() -> int:
    """Ranks of the default process group; 1 when none is initialised."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> Mesh:
    """A :class:`Mesh` of ``shape``, carrying the ``DeviceMesh`` over
    the default group when one is initialised (its device type follows
    the backend: NCCL ranks hold cards, gloo ranks the CPU).  A shape of
    fewer ranks than the world covers its first ranks; every rank of
    the world must build it, as every rank joins a new group."""
    if not dist.is_initialized():
        return Mesh(axes, shape)
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    n = math.prod(shape)
    if n == world_size():
        return Mesh(axes, shape, init_device_mesh(kind, shape,
                                                  mesh_dim_names=axes))
    return Mesh(axes, shape, DeviceMesh(kind, torch.arange(n).reshape(shape),
                                        mesh_dim_names=axes))


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> Mesh:
    """A mesh of ``shape`` over the first ``prod(shape)`` ranks, the
    counterpart of ``jax.make_mesh`` over the first devices: an elastic
    restart re-lays its state onto the ranks that survived
    (:func:`repro_torch.distributed.elastic.remesh_tree`)."""
    shape, axes = tuple(shape), tuple(axes)
    if math.prod(shape) > world_size():
        raise ValueError(f"a mesh of shape {shape} needs "
                         f"{math.prod(shape)} ranks; the world has "
                         f"{world_size()}")
    return _mesh(shape, axes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 512 if multi_pod else 256
    if world_size() != need:
        raise ValueError(
            f"the {'multi-pod' if multi_pod else 'production'} mesh "
            f"{shape} needs a process group of {need} ranks; this one has "
            f"{world_size()}")
    return _mesh(shape, axes)


def make_host_mesh(model: int = 1) -> Mesh:
    """(n // model, model) over the n local ranks, axes (data, model);
    ``model`` is clamped to n, as the JAX package clamps it to its
    devices."""
    n = world_size()
    model = min(model, n)
    if n % model:
        raise ValueError(f"model={model} does not divide the {n} ranks")
    return _mesh((n // model, model), ("data", "model"))


def mesh_chips(mesh: Mesh) -> int:
    return int(mesh.size)


@contextlib.contextmanager
def process_group_from_env(device):
    """Within the block, the default process group from ``torchrun``'s
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``PORT``,
    ``LOCAL_RANK``), when it is there and no group is: NCCL with this
    rank's card (``LOCAL_RANK``) made current for ``device="cuda"``,
    gloo for the CPU.  A group it initialises is destroyed at the end;
    one the caller initialised is left as it is."""
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        yield
        return
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if on_card else "gloo")
    try:
        yield
    finally:
        dist.destroy_process_group()


def rank() -> int:
    """This rank in the default process group; 0 when none is
    initialised."""
    return dist.get_rank() if dist.is_initialized() else 0
