"""The engine's one host boundary.

Blobs live on the host (the :class:`~repro_torch.storage.store.BlobStore`
holds numpy arrays); pipelines run on the engine's device.  Data
crosses between the two at exactly three places, all in
:class:`~repro_torch.core.engine.VDMSAsyncEngine`:

- **in** at launch: an entity's blob becomes a tensor on the engine's
  device when its pipeline is enqueued (:func:`to_device`);
- **out** where a result enters the response (and the ``on_entity``
  stream), so clients receive numpy arrays (:func:`to_host`);
- **out** at the write-back of an ``Add`` with operations, and at
  ingest, because the store keeps host arrays (:func:`to_host`).

Between launch and response an entity's data stays a tensor on the
device: native workers, remote servers, the batcher and the device
backend all pass tensors along.

:func:`resolve_device` is the one reading of a ``device`` argument that
the engine, the model UDF and the model launcher share.
"""
from __future__ import annotations

import numpy as np
import torch


def to_device(data, device: torch.device) -> torch.Tensor:
    """A tensor on ``device`` holding ``data``.  A host array is always
    copied, so no op can reach the store's blob through the tensor."""
    if isinstance(data, torch.Tensor):
        return data.to(device)
    return torch.tensor(np.ascontiguousarray(data), device=device)


def to_host(data):
    """A numpy array holding ``data``: a tensor is copied to the host (a
    CPU tensor too, so the caller never shares memory with a tensor an
    op may still hold); anything else goes through ``np.asarray``."""
    if isinstance(data, torch.Tensor):
        return data.detach().to("cpu", copy=True).numpy()
    return np.asarray(data)


def resolve_device(device) -> torch.device:
    """A ``device`` argument as a torch device: ``"cuda"`` (the current
    card), ``"cuda:<i>"`` or ``"cpu"``.  Raises when CUDA is asked for
    and absent — nothing falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={device!r} asks for the CUDA card, and torch sees "
                "no CUDA device on this host; pass device='cpu' to run on "
                "the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.index >= torch.cuda.device_count():
            raise ValueError(f"device={device!r}: only "
                             f"{torch.cuda.device_count()} CUDA device(s)")
    elif dev.type != "cpu":
        raise ValueError(f"device must be 'cuda', 'cuda:<i>' or 'cpu', "
                         f"got {device!r}")
    return dev
