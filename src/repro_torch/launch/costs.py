"""Per-op costs of one rank's program: the port's counterpart of the JAX
package's ``launch/hlo_costs.py``.

The reference parses the optimized HLO of a compiled step and scales
each ``while`` body by its trip count.  Eager PyTorch has no HLO and no
loops to correct: a layer loop runs its ops once per layer, so the
costs are added op by op as they run (on ``meta`` tensors in the dry
run, where nothing is computed).  :class:`CostCounter` records, over
one rank's program:

- flops: every op in ``torch.utils.flop_counter``'s table (products and
  convolutions), at XLA's convention of 2 x M x N x K a product;
- hbm bytes: the operands' and results' bytes of every op that moves
  data (views, allocations and metadata ops excluded).  This is the
  reference's per-op convention without its fusion rule: eager fuses
  nothing, so every intermediate round-trips memory, as it does on the
  card;
- collective bytes by kind (``all_reduce``, ``all_gather``,
  ``reduce_scatter``, ``all_to_all``, ``broadcast``): the operand bytes
  of each ``c10d`` op, as ``hlo_costs`` counts them;
- ``kernel_breakdown``: the hand-written kernels' launches, products and
  bytes, recorded by their ``meta`` routes
  (``kernels.work.record_kernel``) from the kernels' work formulas, so
  a kernel counts the work the card's kernel does and not the plain
  chunked form's;
- the live bytes of every storage from its creation to its release, and
  their peak (the reference's ``memory_analysis()``).  Meta storages
  hold no data but have their sizes; a tensor's release is seen by a
  ``weakref.finalize`` on it (PyTorch keeps a tensor's Python object
  while its C++ tensor lives, so this fires when the storage's last
  tensor goes), counted per storage across its views.

The card's rates for the roofline terms live beside the kernels' work
formulas, in ``kernels.work``.
"""
from __future__ import annotations

import collections
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels.work import KernelRecorder

# c10d op -> (kind, index of the operand argument)
COLLECTIVES = {
    "allreduce_": ("all_reduce", 0),
    "allreduce_coalesced_": ("all_reduce", 0),
    "_allgather_base_": ("all_gather", 1),
    "allgather_": ("all_gather", 1),
    "allgather_into_tensor_coalesced_": ("all_gather", 1),
    "_reduce_scatter_base_": ("reduce_scatter", 1),
    "reduce_scatter_": ("reduce_scatter", 1),
    "reduce_scatter_tensor_coalesced_": ("reduce_scatter", 1),
    "alltoall_base_": ("all_to_all", 1),
    "alltoall_": ("all_to_all", 1),
    "broadcast_": ("broadcast", 0),
}

# ops that move no data: allocations, views and metadata
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "lift_fresh",
               "detach", "alias", "set_", "resize_", "_local_scalar_dense",
               "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
               "is_same_size", "_has_compatible_shallow_copy_type"}

# in-place ops that overwrite their first operand without reading it
_WRITE_ONLY = {"copy_", "fill_", "zero_", "uniform_", "normal_"}


def _tensors(tree) -> list:
    """The tensors of nested dicts (a cache's dict subclass too), lists
    and tuples."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def _broadcast(shapes) -> list[int]:
    shapes = list(shapes)
    out = [1] * max(len(s) for s in shapes)
    for s in shapes:
        for i, n in enumerate(s, len(out) - len(s)):
            if n != 1:
                if out[i] not in (1, n):
                    raise ValueError(f"shapes {shapes} do not broadcast")
                out[i] = n
    return out


def nbytes(tree) -> int:
    """The bytes of the tensors of a nested tree."""
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


class CostCounter(TorchDispatchMode, KernelRecorder):
    """Within the block, every op's costs added (see the module
    docstring); :meth:`track` registers tensors made before the block
    (the step's inputs) as live."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.hbm_bytes = 0
        self.collective_breakdown: dict[str, int] = collections.Counter()
        self.kernel_breakdown: dict[str, dict] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._storages: dict[int, list] = {}   # key -> [bytes, tensors]
        self._seen: dict[int, int] = {}        # id(tensor) -> storage key
        self._open = True
        self._dtypes: dict = {}

    @property
    def collective_bytes(self) -> int:
        return sum(self.collective_breakdown.values())

    # ---- live bytes
    def track(self, tree) -> None:
        for t in _tensors(tree):
            self._track(t)

    def _track(self, t: torch.Tensor) -> None:
        if id(t) in self._seen:
            return
        try:
            storage = t.untyped_storage()
        except (NotImplementedError, RuntimeError):
            return      # a tensor without a storage of its own
        key = storage._cdata
        entry = self._storages.get(key)
        if entry is None:
            entry = self._storages[key] = [storage.nbytes(), 0]
            self.live_bytes += entry[0]
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        entry[1] += 1
        self._seen[id(t)] = key
        weakref.finalize(t, self._release, id(t), key)

    def _release(self, tid: int, key: int) -> None:
        if not self._open:
            return
        self._seen.pop(tid, None)
        entry = self._storages.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live_bytes -= entry[0]
            del self._storages[key]

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._open = False
        return out

    # ---- the kernels' meta routes
    def kernel(self, name: str, nbytes: int, products: int) -> None:
        row = self.kernel_breakdown.setdefault(
            name, {"launches": 0, "flops": 0, "bytes": 0})
        row["launches"] += 1
        row["flops"] += products
        row["bytes"] += nbytes
        self.flops += products
        self.hbm_bytes += nbytes

    # ---- every op
    def _pointwise_meta(self, func, args, kwargs):
        """A pointwise op's output on ``meta`` without its meta kernel
        (PyTorch's are Python references, about 0.25 ms an op): the
        inputs' broadcast shape, contiguous, in the dtype the kernel gave
        the first time it saw these input dtypes (the kernel would follow
        the inputs' strides; a contiguous result takes every view that
        one would).  ``None`` where this does not apply (an in-place or
        ``out=`` op, a non-meta input, several outputs)."""
        if func._schema.is_mutable or "out" in kwargs:
            return None
        tensors = _tensors(args)
        if not tensors or not all(t.is_meta for t in tensors):
            return None
        key = (func, tuple((t.dtype, t.dim() == 0) for t in tensors),
               tuple(type(a) for a in args), repr(sorted(kwargs.items())))
        dtype = self._dtypes.get(key)
        if dtype is None:
            out = func(*args, **kwargs)
            self._dtypes[key] = (out.dtype if isinstance(out, torch.Tensor)
                                 else False)
            return out
        if dtype is False:
            return None
        return torch.empty(_broadcast(t.shape for t in tensors),
                           dtype=dtype, device="meta")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = None
        if torch.Tag.pointwise in func.tags:
            out = self._pointwise_meta(func, args, kwargs)
        if out is None:
            out = func(*args, **kwargs)
        packet = func.overloadpacket
        name = packet.__name__
        coll = COLLECTIVES.get(name) if func.namespace == "c10d" else None
        if coll is not None:
            b = nbytes(args[coll[1]])
            self.collective_breakdown[coll[0]] += b
            self.hbm_bytes += b + nbytes(out)
        elif packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if coll is None and name not in _NO_TRAFFIC and not func.is_view:
            reads = args[1:] if name in _WRITE_ONLY else args
            self.hbm_bytes += nbytes((reads, kwargs)) + nbytes(out)
        for t in _tensors(out):
            self._track(t)
        return out

    def summary(self) -> dict:
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "collective_bytes": self.collective_bytes,
                "collective_breakdown": dict(self.collective_breakdown),
                "kernel_breakdown": {k: dict(v) for k, v in
                                     self.kernel_breakdown.items()},
                "peak_bytes": self.peak_bytes}
