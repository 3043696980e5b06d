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
ranks; only :func:`tree_to_shardings`'s use in ``elastic.remesh_tree``
and :func:`constrain` on a DTensor need the ``DeviceMesh`` behind it.
What executes on a mesh today is data parallelism (a ``model`` axis of
1): :class:`ShardingCtx` refuses a wider model axis.
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


def constrain(x, axes: Sequence[str | None], rules: LogicalRules,
              mesh: Mesh | None):
    """The sharding constraint of ``axes``: the identity off a mesh, on a
    mesh of one rank and on a plain tensor; a DTensor is redistributed
    to the spec's placements."""
    if mesh is None or mesh.size == 1:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    spec = safe_spec(x.shape, axes, rules, mesh)
    return x.redistribute(mesh.device_mesh, placements(spec, mesh))


@dataclasses.dataclass
class ShardingCtx:
    """Carried through model apply functions: mesh + active rules.
    ``mesh=None`` means one device and no constraints.  A mesh whose
    ``model`` axis is above one rank needs tensor-parallel execution,
    which is not ported: it raises."""
    mesh: Mesh | None = None
    rules: LogicalRules = dataclasses.field(default_factory=default_rules)

    def __post_init__(self):
        if self.mesh is not None and self.mesh.sizes.get("model", 1) > 1:
            raise NotImplementedError(
                f"a mesh {self.mesh.sizes} with a model axis above one rank "
                "needs tensor-parallel execution (the state and activations "
                "as DTensors), which comes with the tensor-parallel slice; "
                "use model_par=1 (data parallelism over the ranks)")

    def __call__(self, x, *axes: str | None):
        return constrain(x, axes, self.rules, self.mesh)

    def with_overrides(self, overrides: Mapping[str, Any] | None
                       ) -> "ShardingCtx":
        if not overrides:
            return self
        rules = dict(self.rules)
        rules.update(overrides)
        return ShardingCtx(mesh=self.mesh, rules=rules)


REPLICATED = ShardingCtx(mesh=None)
