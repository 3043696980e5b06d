"""The engine's one host boundary.

Blobs live on the host (the :class:`~repro_torch.storage.store.BlobStore`
holds numpy arrays); pipelines run on the engine's device.  Data
crosses between the two at exactly three places, all in
:class:`~repro_torch.core.engine.VDMSAsyncEngine` and its
:class:`~repro_torch.core.session.QuerySession`:

- **in** at launch: an entity's blob becomes a tensor on the engine's
  device when its pipeline is enqueued (:func:`to_device`);
- **out** into the response, once a query: a finished entity keeps its
  tensor until the query's last entity is done, and then all of the
  query's results come to the host in one call (:func:`to_host_many`:
  one stacked copy a run of tensors that share a device, shape and
  dtype, into pinned memory on a CUDA card), so clients receive numpy
  arrays; an expansion's born-done entities cross the same way, one
  call an expansion.  A query whose held results reach
  :data:`OUT_COPY_BYTES` brings those over at once, and no stacked copy
  is larger, so a query never holds more than about that much on the
  device for its response, nor a client's kept row more pinned memory;
- **out** one entity at a time (:func:`to_host`) where a host array is
  needed as the entity finishes: a session's ``on_entity`` stream, the
  write-back of an ``Add`` with operations, and ingest, because the
  store keeps host arrays.

Either way out, the caller never shares memory with a tensor an op may
still hold: it receives fresh host memory (a row of one host block that
only the response holds, from :func:`to_host_many`).

Between launch and response an entity's data stays a tensor on the
device: native workers, remote servers, the batcher and the device
backend all pass tensors along.

:func:`resolve_device` is the one reading of a ``device`` argument that
the engine, the model UDF and the model launcher share.
"""
from __future__ import annotations

import numpy as np
import torch

# the most one stacked copy of the way out holds, and the most of its
# results a query keeps on the device before they cross
OUT_COPY_BYTES = 128 << 20


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


def to_host_many(datas) -> tuple[list, int]:
    """The numpy arrays :func:`to_host` gives for each of ``datas``, in
    order, and the number of copies made: one for each run of tensors
    that share a device, a shape and a dtype, cut into stacks of at most
    :data:`OUT_COPY_BYTES` (a larger tensor is a stack of its own).  A
    stack is made on the tensors' device (on the card, one
    device-to-device copy), copied to the host, and each tensor's array
    is a view of its row.  On a CUDA device the copy is
    ``non_blocking`` into pinned memory (PyTorch's caching host
    allocator reuses the blocks), queued on the device's current stream
    after the work that made the tensors, and waited for alone; a CPU
    stack is the copy.  Anything else goes through ``np.asarray``."""
    out: list = [None] * len(datas)
    runs: dict[tuple, list[int]] = {}
    for i, d in enumerate(datas):
        if isinstance(d, torch.Tensor):
            runs.setdefault((d.device, d.shape, d.dtype), []).append(i)
        else:
            out[i] = np.asarray(d)
    copied = []
    copies = 0
    for (dev, _, _), idx in runs.items():
        step = max(1, OUT_COPY_BYTES // max(1, datas[idx[0]].nbytes))
        for lo in range(0, len(idx), step):
            chunk = idx[lo:lo + step]
            stack = torch.stack([datas[i].detach() for i in chunk])
            if dev.type == "cuda":
                host = torch.empty(stack.shape, dtype=stack.dtype,
                                   pin_memory=True)
                host.copy_(stack, non_blocking=True)
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(dev))
                copied.append(done)
            else:
                host = stack
            copies += 1
            rows = host.numpy()
            for k, i in enumerate(chunk):
                out[i] = rows[k, ...]
    for done in copied:
        done.synchronize()
    return out, copies


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
