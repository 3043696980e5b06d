"""Logical-axis sharding (MaxText-style rules) over a torch DeviceMesh.

Every parameter / activation carries a tuple of *logical* axis names
(e.g. ``("embed", "ff")``).  A rules table maps logical names to mesh
axes.  This indirection lets one model definition serve every mesh in
``repro_torch.launch.mesh`` (single-pod 16x16, multi-pod 2x16x16, and
the one-rank meshes of a single card or a CPU test) and lets a config
re-shard a model by editing one dict instead of touching layer code.

Conventions (the JAX package's rules table, copied):

- ``batch``      -> all data-parallel axes ("pod" and "data" when present).
- ``vocab``      -> "model" (embedding + logits are vocab-sharded).
- ``ff`` / ``heads_fused`` / ``expert_ff`` -> "model" (tensor parallel).
- ``experts``    -> "data"  (expert storage sharded over the DP axis).
- ``cache_seq``  -> "model" for decode KV caches.
- anything unknown -> replicated.

Rules may map a logical axis to ``None`` (replicate), a mesh axis name,
or a tuple of mesh axis names.  Mesh axes absent from the active mesh
are dropped so the same rules work on one-rank meshes.

The spec arithmetic (:func:`logical_to_spec`, :func:`safe_spec`,
:func:`tree_to_specs`) reads only a mesh's axis names and shape, so it
runs on a :class:`Mesh` of any shape whether or not the world has its
ranks.  What executes on a mesh is data parallelism over ``data`` and
tensor and expert parallelism over ``model``: every rank holds the
local shard of each leaf that its spec names (:func:`local_shard`,
:class:`Layout`), and the model's apply functions compute on those
local tensors with the explicit collectives of :class:`ShardingCtx`
(``reduce``, ``copy``, ``gather`` over one mesh axis's process group),
not on DTensor's propagation: the kernels are custom ops, the MoE's
sorts and the caches' in-place writes need no rules, and a gloo group
carries only ``all_reduce`` and ``broadcast`` on CUDA tensors.  DTensors
appear only where ``elastic.remesh_tree`` makes them, and a context's
sharding constraint (``sh(x, *axes)``) is the identity.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Sequence

LogicalRules = Mapping[str, Any]  # logical axis -> None | str | tuple[str, ...]


class P(tuple):
    """A partition spec: one entry per tensor dimension — ``None``
    (replicated), a mesh axis name, or a tuple of mesh axis names —
    trailing ``None`` entries trimmed by the functions that build one
    (the JAX package's ``PartitionSpec``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named mesh axes over ranks: ``axis_names`` and ``shape`` (one size
    per axis), and the ``torch.distributed.device_mesh.DeviceMesh`` it
    stands for when the world has its ranks (``None`` otherwise: the
    spec arithmetic needs only the names and sizes)."""
    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    device_mesh: Any = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"axes {self.axis_names} and shape "
                             f"{self.shape} differ in length")

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def sizes(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    @property
    def batch_extent(self) -> int:
        """Ranks the ``batch`` rows are split over: pod x data."""
        return self.sizes.get("pod", 1) * self.sizes.get("data", 1)


def default_rules() -> dict[str, Any]:
    """Baseline rules table (the JAX package's, unchanged).  A config
    overrides entries through ``ArchConfig.sharding_overrides``."""
    return {
        # activations
        "batch": ("pod", "data"),
        "seq": None,
        "embed": None,
        "act_ff": "model",
        "act_heads": "model",
        "cache_seq": "model",
        "cache_heads": None,
        # params: attention / mlp
        "vocab": "model",
        "ff": "model",
        "heads_fused": "model",   # fused (num_heads * head_dim) projection dim
        "kv_fused": "model",      # fused (num_kv_heads * head_dim) dim
        "head_dim": None,
        # params: MoE
        "experts": "data",
        "expert_ff": "model",
        # params: SSM / conv
        "ssm_inner": "model",
        "ssm_state": None,
        "ssm_heads": None,
        "conv_k": None,
        # scan-over-layers leading axis
        "layers": None,
        # replicated scalars etc.
        None: None,
    }


def logical_to_spec(axes: Sequence[str | None] | None, rules: LogicalRules,
                    mesh: Mesh) -> P:
    """Translate a tuple of logical axis names into a :class:`P`.

    Each mesh axis is used at most once (the first logical axis that
    claims it wins; later claims fall back to replication) and only
    axes present in ``mesh`` are referenced."""
    if axes is None:
        return P()
    present = set(mesh.axis_names)
    used: set[str] = set()
    out: list[Any] = []
    for name in axes:
        entry = rules.get(name, None) if name is not None else None
        if entry is None:
            out.append(None)
            continue
        if isinstance(entry, str):
            entry = (entry,)
        picked = tuple(a for a in entry if a in present and a not in used)
        used.update(picked)
        if not picked:
            out.append(None)
        elif len(picked) == 1:
            out.append(picked[0])
        else:
            out.append(picked)
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def _extent(entry, sizes) -> int:
    names = (entry,) if isinstance(entry, str) else entry
    return math.prod(sizes[n] for n in names)


def spec_divisible(shape: Sequence[int], spec: P, mesh: Mesh) -> bool:
    """True if every sharded dim of ``shape`` divides evenly."""
    sizes = mesh.sizes
    return all(entry is None or dim % _extent(entry, sizes) == 0
               for dim, entry in zip(shape, spec))


def safe_spec(shape: Sequence[int], axes, rules: LogicalRules,
              mesh: Mesh) -> P:
    """:func:`logical_to_spec`, demoting any unevenly divisible dim to
    replicated (even shards keep checkpoint layouts and memory exact)."""
    entries = list(logical_to_spec(axes, rules, mesh))
    entries += [None] * (len(shape) - len(entries))
    sizes = mesh.sizes
    for i, (dim, entry) in enumerate(zip(shape, entries)):
        if entry is not None and dim % _extent(entry, sizes) != 0:
            entries[i] = None
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


def local_rows(batch: dict, n: int, index: int) -> dict:
    """The block of rows of every input that the ``"batch" -> ("pod",
    "data")`` rule puts on data index ``index`` of ``n``; every row when
    they do not split evenly (the divisibility demotion replicates
    them)."""
    B = next(iter(batch.values())).shape[0]
    if n == 1 or B % n:
        return batch
    per = B // n
    return {k: v[index * per:(index + 1) * per] for k, v in batch.items()}


def map_with_axes(fn, tree, axes_tree):
    """``fn(leaf, axes)`` over ``tree``'s leaves: ``axes_tree`` has
    ``tree``'s dict structure with a tuple of logical axis names (or
    ``None``) where ``tree`` has a leaf."""
    if isinstance(tree, dict):
        return {k: map_with_axes(fn, v, axes_tree[k]) for k, v in tree.items()}
    return fn(tree, axes_tree)


def placements(spec: P, mesh: Mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh``: per mesh axis,
    ``Shard(d)`` for the tensor dim ``d`` it splits, else
    ``Replicate()``.  A dim split over several mesh axes is split over
    them in mesh order (pod before data, as the rules name them)."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate() for _ in mesh.axis_names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for name in (entry,) if isinstance(entry, str) else entry:
            out[mesh.axis_names.index(name)] = Shard(d)
    return out


def tree_to_specs(param_tree: Any, spec_tree: Any, mesh: Mesh,
                  rules: LogicalRules) -> Any:
    """Mirror a (params, logical-axes) tree pair into the specs of
    :func:`safe_spec` (a leaf needs only a ``shape``: a tensor, a meta
    tensor, a size)."""
    return map_with_axes(lambda p, axes: safe_spec(
        tuple(getattr(p, "shape", ())), axes, rules, mesh),
        param_tree, spec_tree)


def tree_to_shardings(param_tree: Any, spec_tree: Any, mesh: Mesh,
                      rules: LogicalRules) -> Any:
    """Per leaf, the DTensor placements its :func:`safe_spec` gives on
    ``mesh`` (the JAX package's ``NamedSharding`` per leaf)."""
    return map_with_axes(lambda spec, _: placements(spec, mesh),
                      tree_to_specs(param_tree, spec_tree, mesh, rules),
                      spec_tree)


def entry_names(entry) -> tuple[str, ...]:
    return () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))


def local_shard(full, spec: P, mesh: Mesh, coords: Mapping[str, int]):
    """Rank ``coords``' shard of the ``full`` leaf under ``spec``: each
    split dim narrowed to the block of its mesh axes' flat index (the
    first-named axis outermost, as DTensor splits over mesh dims in
    order), copied so the full leaf can be freed.  A leaf with nothing
    split is returned as it is."""
    sizes = mesh.sizes
    out = full
    for d, entry in enumerate(spec):
        names = entry_names(entry)
        if not names:
            continue
        n, i = 1, 0
        for a in names:
            n, i = n * sizes[a], i * sizes[a] + coords.get(a, 0)
        per = full.shape[d] // n
        out = out.narrow(d, i * per, per)
    return out if out is full else out.clone()


class Axis:
    """One mesh axis's process group as this rank sees it: ``size``
    ranks, this one at ``index``.  The collectives return new tensors.
    NCCL runs its own all-gather and reduce-scatter; on gloo, which
    carries only ``all_reduce`` and ``broadcast`` for CUDA tensors, an
    all-gather is the sum of a zero buffer holding this rank's block in
    place, and a reduce-scatter the block of a full sum.  A ``fake``
    group (the dry run's ranks, which move no data) takes NCCL's route,
    so the collectives counted are those production ranks send."""

    def __init__(self, group, size: int, index: int):
        import torch.distributed as dist
        self.group, self.size, self.index = group, size, index
        self.nccl = dist.get_backend(group) in ("nccl", "fake")

    def all_reduce(self, x):
        import torch.distributed as dist
        out = x.clone()
        dist.all_reduce(out, group=self.group)
        return out

    def all_gather(self, x, dim: int):
        import torch
        import torch.distributed as dist
        dim %= x.ndim
        if self.nccl:
            buf = x.new_empty((self.size, *x.shape))
            dist.all_gather_into_tensor(buf, x.contiguous(), group=self.group)
            return torch.cat(buf.unbind(0), dim=dim)
        shape = list(x.shape)
        shape[dim] *= self.size
        buf = x.new_zeros(shape)
        buf.narrow(dim, self.index * x.shape[dim], x.shape[dim]).copy_(x)
        dist.all_reduce(buf, group=self.group)
        return buf

    def block(self, x, dim: int):
        """This rank's block of ``x`` along ``dim``."""
        per = x.shape[dim] // self.size
        return x.narrow(dim, self.index * per, per)

    def reduce_scatter(self, x, dim: int):
        import torch
        import torch.distributed as dist
        if self.nccl:
            dim %= x.ndim
            parts = torch.stack(x.chunk(self.size, dim=dim)).contiguous()
            out = parts.new_empty(parts.shape[1:])
            dist.reduce_scatter_tensor(out, parts, group=self.group)
            return out
        return self.block(self.all_reduce(x), dim).contiguous()


def _functions():
    """The autograd Functions over an :class:`Axis` (Megatron's f and
    g, and the gather to a replicated tensor), made at first use so the
    module imports without torch."""
    import torch

    class Reduce(torch.autograd.Function):
        """Forward the sum over the axis; backward the identity (the
        sum feeds computation that every rank repeats alike)."""
        @staticmethod
        def forward(ctx, x, axis):
            return axis.all_reduce(x)

        @staticmethod
        def backward(ctx, g):
            return g, None

    class Copy(torch.autograd.Function):
        """Forward the identity; backward the sum over the axis (the
        value feeds computation that differs by rank)."""
        @staticmethod
        def forward(ctx, x, axis):
            ctx.axis = axis
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            return ctx.axis.all_reduce(g), None

    class Gather(torch.autograd.Function):
        """Forward the all-gather along ``dim``; backward this rank's
        block of the gradient (the full tensor feeds computation that
        every rank repeats alike), or with ``summed`` the reduce-scatter
        of it (the full tensor feeds computation that differs by
        rank)."""
        @staticmethod
        def forward(ctx, x, axis, dim, summed):
            ctx.axis, ctx.dim, ctx.summed = axis, dim, summed
            return axis.all_gather(x, dim)

        @staticmethod
        def backward(ctx, g):
            if ctx.summed:
                return ctx.axis.reduce_scatter(g, ctx.dim), None, None, None
            return ctx.axis.block(g, ctx.dim), None, None, None

    return Reduce, Copy, Gather


_FUNCTIONS: list = []


def _fn(i: int):
    if not _FUNCTIONS:
        _FUNCTIONS.extend(_functions())
    return _FUNCTIONS[i]


@dataclasses.dataclass
class ShardingCtx:
    """Carried through model apply functions: mesh + active rules, and
    this rank's place on the mesh.  ``mesh=None`` means one device and
    no collectives.  On a mesh with its ``DeviceMesh`` the context
    gives this rank's coordinates (``data_index``, ``model_index``), the
    :class:`Axis` of each mesh axis, and the collectives the apply
    functions place by hand; each is the identity when its axis has one
    rank, so a one-rank run takes exactly the single-device code."""
    mesh: Mesh | None = None
    rules: LogicalRules = dataclasses.field(default_factory=default_rules)
    _axes: dict = dataclasses.field(default_factory=dict, repr=False,
                                    compare=False)

    def __call__(self, x, *axes: str | None):
        """The reference's sharding constraint of ``x`` to ``axes``: the
        identity, since every tensor here is already this rank's local
        block (the calls mark where the reference constrains)."""
        return x

    def with_overrides(self, overrides: Mapping[str, Any] | None
                       ) -> "ShardingCtx":
        if not overrides:
            return self
        rules = dict(self.rules)
        rules.update(overrides)
        return ShardingCtx(mesh=self.mesh, rules=rules, _axes=self._axes)

    # ---- this rank on the mesh
    def size(self, name: str) -> int:
        return 1 if self.mesh is None else self.mesh.sizes.get(name, 1)

    @property
    def tp(self) -> int:
        """Ranks of the ``model`` axis."""
        return self.size("model")

    @property
    def coords(self) -> dict[str, int]:
        if self.mesh is None or self.mesh.size == 1:
            return {}
        if "coords" not in self._axes:
            dm = self.mesh.device_mesh
            if dm is None:
                raise ValueError(f"a mesh of {self.mesh.size} ranks needs its "
                                 "DeviceMesh (a process group of that size)")
            self._axes["coords"] = dict(zip(self.mesh.axis_names,
                                            dm.get_coordinate()))
        return self._axes["coords"]

    @property
    def model_index(self) -> int:
        return self.coords.get("model", 0)

    @property
    def data_index(self) -> int:
        """This rank's index over the ``batch`` axes (pod x data)."""
        c = self.coords
        return c.get("pod", 0) * self.size("data") + c.get("data", 0)

    def axis(self, name: str) -> Axis | None:
        """The process group of mesh axis ``name``; ``None`` when it has
        one rank."""
        if self.size(name) == 1:
            return None
        if name not in self._axes:
            dm = self.mesh.device_mesh
            self._axes[name] = Axis(dm.get_group(name), self.size(name),
                                    self.coords[name])
        return self._axes[name]

    # ---- the collectives, autograd-aware, over one axis
    def reduce(self, x, axis: str = "model"):
        """The sum over ``axis`` (a row-parallel product's partial sums);
        its gradient passes through."""
        a = self.axis(axis)
        return x if a is None else _fn(0).apply(x, a)

    def copy(self, x, axis: str = "model"):
        """``x`` entering computation that differs by rank: the identity,
        whose gradient is summed over ``axis``."""
        a = self.axis(axis)
        return x if a is None else _fn(1).apply(x, a)

    def gather(self, x, dim: int, axis: str = "model",
               summed: bool = False):
        """The blocks of ``x`` along ``dim`` from every rank of ``axis``,
        in rank order.  The gradient keeps this rank's block; with
        ``summed`` (the full tensor feeds computation that differs by
        rank) it is the reduce-scatter of every rank's gradient."""
        a = self.axis(axis)
        if a is None:
            return self.copy(x, axis) if summed else x
        return _fn(2).apply(x, a, dim, summed)

    # ---- the rules for one dim
    def split(self, logical: str, size: int, axis: str = "model") -> bool:
        """Whether a dim of ``size`` under the logical axis ``logical`` is
        split over mesh axis ``axis`` (alone), as :func:`safe_spec` puts
        it."""
        if self.mesh is None or self.size(axis) == 1:
            return False
        spec = safe_spec((size,), (logical,), self.rules, self.mesh)
        return bool(spec) and entry_names(spec[0]) == (axis,)


class Layout:
    """The specs of a tree of full leaves (tensors or shapes) under a
    context's mesh and rules, and the moves between full and local
    trees: :meth:`local` narrows each full leaf to this rank's shard,
    :meth:`full` gathers each local leaf back over the axes that split
    it (every rank of the mesh takes part)."""

    def __init__(self, sh: ShardingCtx, full_tree, axes_tree):
        self.sh = sh
        self.specs = (None if sh.mesh is None else
                      tree_to_specs(full_tree, axes_tree, sh.mesh, sh.rules))

    def local(self, full_tree, device=None):
        """Each leaf's shard on this rank, moved to ``device`` when one
        is given (a full tree on the host reaches the card a shard at a
        time); on one rank the tree as it is."""
        if self.specs is None or self.sh.mesh.size == 1:
            return full_tree
        coords = self.sh.coords

        def cut(leaf, spec):
            out = local_shard(leaf, spec, self.sh.mesh, coords)
            return out if device is None else out.to(device)
        return map_with_axes(cut, full_tree, self.specs)

    def dtensors(self, local_tree):
        """The local shards as DTensors on the mesh's ``DeviceMesh``."""
        from torch.distributed.tensor import DTensor
        mesh = self.sh.mesh
        return map_with_axes(lambda leaf, spec: DTensor.from_local(
            leaf, mesh.device_mesh, placements(spec, mesh), run_check=False),
            local_tree, self.specs)

    def full(self, local_tree):
        if self.specs is None or self.sh.mesh.size == 1:
            return local_tree

        def gather(leaf, spec):
            for d, entry in enumerate(spec):
                names = [a for a in entry_names(entry)
                         if self.sh.size(a) > 1]
                if len(names) > 1:
                    raise NotImplementedError(
                        f"a dim split over {names} at once")
                if names:
                    leaf = self.sh.axis(names[0]).all_gather(leaf, d)
            return leaf
        return map_with_axes(gather, local_tree, self.specs)


REPLICATED = ShardingCtx(mesh=None)
