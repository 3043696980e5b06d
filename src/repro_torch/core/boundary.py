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
