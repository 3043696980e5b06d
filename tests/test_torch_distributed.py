"""The distribution substrate in one process: the port's logical-axis
rules, specs and meshes (``repro_torch.distributed.sharding``,
``launch.mesh``, ``launch.specs``, the caches' axis trees,
``elastic.shrink_batch_for_mesh``) against the JAX package's.

The reference's spec functions read a mesh's ``axis_names`` and
``devices.shape`` and nothing else, so its side gets a duck-typed mesh
(``devices = np.empty(shape)``) and needs no JAX devices; the port's
side gets its own :class:`Mesh` of the same shape, with no process
group.  Every spec is compared entry by entry, for all ten configs, on
the meshes (1, 1), (2, 4), (16, 16) and (2, 16, 16), under the rules
the reference's launchers and dry run build: the defaults with the
config's ``sharding_overrides``, and with its ``train_`` and
``prefill_`` overrides on top.  The parameter shapes are the
reference's (``jax.eval_shape`` of its init, as meta tensors on the
port's side; the reduced configs' port init is checked to give the same
shapes), so no full-width model is allocated.  Multi-rank runs are in
``tests/test_torch_distributed_ranks.py``.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS as JAX_ARCHS
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_arch as jax_arch
from repro.distributed import elastic as jax_elastic
from repro.distributed import sharding as jsh
from repro.launch import specs as jax_specs
from repro.models import get_model as jax_model
from repro.training.train_step import train_state_axes as jax_state_axes
from repro_torch.configs import ALL_ARCHS, SHAPES, get_arch
from repro_torch.distributed import elastic
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs
from repro_torch.models import get_model
from repro_torch.training.train_step import train_state_axes

MESHES = {(1, 1): ("data", "model"), (2, 4): ("data", "model"),
          (16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model")}
DTYPES = {jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.int32): torch.int32}


def _meshes(shape):
    axes = MESHES[shape]
    duck = types.SimpleNamespace(axis_names=axes, devices=np.empty(shape))
    return duck, tsh.Mesh(axes, shape)


def _rule_sets(cfg):
    """The rules the reference builds: its launchers' (defaults + the
    config's ``sharding_overrides``) and its dry run's train and
    prefill cells (those + the cell kind's overrides)."""
    base = dict(jsh.default_rules())
    base.update(cfg.sharding_overrides or {})
    out = {"base": base}
    for kind in ("train", "prefill"):
        extra = getattr(cfg, f"{kind}_sharding_overrides")
        out[kind] = {**base, **(extra or {})}
    return out


def _meta(tree):
    return jax.tree.map(lambda s: torch.empty(s.shape, device="meta",
                                              dtype=DTYPES[s.dtype]), tree)


def _assert_specs_equal(port, ref, path=()):
    if isinstance(ref, dict):
        assert set(port) == set(ref), path
        for k in ref:
            _assert_specs_equal(port[k], ref[k], path + (k,))
        return
    assert isinstance(port, tsh.P), path
    assert tuple(port) == tuple(ref), (path, port, ref)


_SHAPES = {}


def _param_shapes(arch):
    """The reference's parameter shapes of ``arch`` at full width."""
    if arch not in _SHAPES:
        api = jax_model(jax_arch(arch))
        _SHAPES[arch] = jax.eval_shape(lambda: api.init(
            jax.random.PRNGKey(0)))
    return _SHAPES[arch]


# ------------------------------------------------------------ the rules
def test_rules_and_spec_arithmetic_match_the_reference():
    assert tsh.default_rules() == jsh.default_rules()
    duck, mesh = _meshes((2, 4))
    rules = tsh.default_rules()
    cases = [(("batch", "seq", "act_heads", None), (2, 16, 14, 64)),
             (("batch", "seq", "act_heads", None), (2, 16, 16, 64)),
             (("vocab", "embed"), (1000, 64)), (("embed", "vocab"), (64, 1024)),
             (("experts", "embed", "expert_ff"), (8, 32, 12)),
             (("batch", "batch", "ff"), (4, 4, 8)), (None, (3,)), ((), ()),
             (("layers", "cache_seq", "cache_heads"), (2, 7, 4))]
    for axes, shape in cases:
        for overrides in (None, {"experts": "model", "expert_ff": "data"},
                          {"cache_seq": None, "cache_heads": "model"}):
            r = dict(rules, **(overrides or {}))
            want = jsh.logical_to_spec(axes, r, duck)
            got = tsh.logical_to_spec(axes, r, mesh)
            assert tuple(got) == tuple(want), (axes, overrides)
            want = jsh.safe_spec(shape, axes, r, duck)
            assert tuple(tsh.safe_spec(shape, axes, r, mesh)) == tuple(want)
            spec = tsh.logical_to_spec(axes, r, mesh)
            assert tsh.spec_divisible(shape, spec, mesh) == \
                jsh.spec_divisible(shape, jsh.logical_to_spec(axes, r, duck),
                                   duck)
    # the demotion the reference's own test pins
    spec = tsh.safe_spec((2, 16, 14, 64), ("batch", "seq", "act_heads", None),
                         rules, mesh)
    assert spec == tsh.P("data") and repr(spec) == "P('data')"
    sh = tsh.ShardingCtx(mesh=None).with_overrides({"ff": None})
    assert sh.rules["ff"] is None and sh.rules["vocab"] == "model"
    assert tsh.ShardingCtx().with_overrides(None).rules == rules


def test_placements_name_the_spec_per_mesh_axis():
    from torch.distributed.tensor import Replicate, Shard
    mesh = tsh.Mesh(("pod", "data", "model"), (2, 16, 16))
    got = tsh.placements(tsh.P(("pod", "data"), None, "model"), mesh)
    assert got == [Shard(0), Shard(0), Shard(2)]
    assert tsh.placements(tsh.P(), mesh) == [Replicate()] * 3
    tree = {"w": torch.empty((32, 16, 8), device="meta")}
    axes = {"w": ("batch", None, "ff")}
    assert tsh.tree_to_shardings(tree, axes, mesh, tsh.default_rules()) == {
        "w": [Shard(0), Shard(0), Replicate()]}    # 8 % 16: demoted


def test_constrain_is_the_identity_off_a_mesh_and_on_plain_tensors():
    # the apply functions compute on local blocks with explicit
    # collectives, so a context's constraint is the identity on every mesh
    x = torch.ones(4, 8)
    for sh in (tsh.REPLICATED,
               tsh.ShardingCtx(mesh=tsh.Mesh(("data", "model"), (1, 1))),
               tsh.ShardingCtx(mesh=tsh.Mesh(("data", "model"), (4, 1))),
               tsh.ShardingCtx(mesh=tsh.Mesh(("data", "model"), (2, 2)))):
        assert sh(x, "batch", "ff") is x


# -------------------------------------------- params, state and caches
@pytest.mark.parametrize("arch", JAX_ARCHS)
@pytest.mark.parametrize("shape", list(MESHES))
def test_param_and_state_specs_match_the_reference(arch, shape):
    duck, mesh = _meshes(shape)
    jcfg, cfg = jax_arch(arch), get_arch(arch)
    jparams = _param_shapes(arch)
    tparams = _meta(jparams)
    japi, api = jax_model(jcfg), get_model(cfg)
    assert api.param_axes() == japi.param_axes()
    jstate = {"params": jparams, "m": jparams, "v": jparams,
              "step": jax.ShapeDtypeStruct((), jnp.int32)}
    tstate = {"params": tparams, "m": tparams, "v": tparams,
              "step": torch.empty((), dtype=torch.int32, device="meta")}
    for name, rules in _rule_sets(jcfg).items():
        _assert_specs_equal(
            tsh.tree_to_specs(tparams, api.param_axes(), mesh, rules),
            jsh.tree_to_specs(jparams, japi.param_axes(), duck, rules))
        _assert_specs_equal(
            tsh.tree_to_specs(tstate, train_state_axes(api), mesh, rules),
            jsh.tree_to_specs(jstate, jax_state_axes(japi), duck, rules))


@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_cache_axes_and_cache_specs_match_the_reference(arch):
    jcfg, cfg = jax_arch(arch), get_arch(arch)
    japi, api = jax_model(jcfg), get_model(cfg)
    assert api.cache_axes() == japi.cache_axes()
    B, S = 128, 32_768      # decode_32k
    jcache = jax.eval_shape(lambda: japi.init_cache(B, S, jnp.bfloat16))
    tcache = api.init_cache(B, S, torch.bfloat16, device="meta")
    for shape in MESHES:
        duck, mesh = _meshes(shape)
        for rules in _rule_sets(jcfg).values():
            _assert_specs_equal(
                tsh.tree_to_specs(tcache, api.cache_axes(), mesh, rules),
                jsh.tree_to_specs(jcache, japi.cache_axes(), duck, rules))


@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_reduced_port_init_has_the_reference_shapes(arch):
    """The spec tests take the reference's full-width shapes; the port's
    own init gives the same tree and shapes (at reduced width)."""
    cfg = get_arch(arch, reduced=True)
    api = jax_model(jax_arch(arch, reduced=True))
    want = jax.eval_shape(lambda: api.init(jax.random.PRNGKey(0)))
    got = get_model(cfg).init(torch.Generator().manual_seed(0))
    _assert_same_shapes(got, want)


def _assert_same_shapes(port, ref, path=()):
    if isinstance(ref, dict):
        assert set(port) == set(ref), path
        for k in ref:
            _assert_same_shapes(port[k], ref[k], path + (k,))
        return
    assert tuple(port.shape) == tuple(ref.shape), path
    assert port.dtype == DTYPES[jnp.dtype(ref.dtype)], path


@pytest.mark.parametrize("reduced", [False, True])
def test_phase_18_param_bytes_are_the_reference_rules(reduced):
    """``chip_smoke.py``'s phase 18 holds each rank's parameter bytes at
    ``model_par=2`` against a table; the table is what the reference's
    rules and spec arithmetic give its parameter shapes (float32)."""
    import chip_smoke
    duck = types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty((1, chip_smoke.TP_RANKS)))
    sizes = dict(zip(duck.axis_names, duck.devices.shape))
    for run in chip_smoke.tp_runs(reduced):
        if run["kind"] == "train":
            continue
        cfg = jax_arch(run["arch"], reduced=reduced)
        if run.get("layers"):       # a run cut in depth
            cfg = cfg.replace(num_layers=run["layers"])
        rules = dict(jsh.default_rules())
        if run.get("overrides") or run.get("ep"):
            rules.update(cfg.sharding_overrides or {})
        if run.get("ep"):
            rules.update(cfg.prefill_sharding_overrides)
        api = jax_model(cfg)
        shapes = (_param_shapes(run["arch"])
                  if not reduced and not run.get("layers") else
                  jax.eval_shape(lambda: api.init(jax.random.PRNGKey(0))))
        specs = jax.tree.leaves(
            jsh.tree_to_specs(shapes, api.param_axes(), duck, rules),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        want = 0
        for leaf, spec in zip(jax.tree.leaves(shapes), specs):
            n = int(np.prod(leaf.shape))
            for entry in spec:
                for a in ((entry,) if isinstance(entry, str) else entry or ()):
                    n //= sizes[a]
            want += 4 * n
        assert run["param_bytes"] == want, run["name"]


# ------------------------------------------------ input specs and SHAPES
def test_shapes_match_the_reference():
    assert set(SHAPES) == set(JAX_SHAPES)
    for name, s in SHAPES.items():
        j = JAX_SHAPES[name]
        assert (s.name, s.seq_len, s.global_batch, s.kind, s.is_decode) == (
            j.name, j.seq_len, j.global_batch, j.kind, j.is_decode)


@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_input_specs_match_the_reference(arch):
    jcfg, cfg = jax_arch(arch), get_arch(arch)
    for name in SHAPES:
        want = jax_specs.input_specs(jcfg, JAX_SHAPES[name])
        got = specs.input_specs(cfg, SHAPES[name])
        _assert_same_shapes(got, want, (arch, name))
        for leaf in jax.tree.leaves(got):
            assert leaf.device.type == "meta"


# ------------------------------------------------------- meshes, elastic
def test_host_mesh_clamps_model_par_to_the_ranks():
    assert not torch.distributed.is_initialized()
    for model in (1, 2, 8):
        m = tmesh.make_host_mesh(model=model)
        assert (m.axis_names, m.shape, m.size) == (("data", "model"), (1, 1),
                                                   1)
        assert m.device_mesh is None and tmesh.mesh_chips(m) == 1
    for multi_pod, need in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"{need} ranks"):
            tmesh.make_production_mesh(multi_pod=multi_pod)


def test_shrink_batch_for_mesh_matches_the_reference():
    for shape in MESHES:
        duck, mesh = _meshes(shape)
        for b in (1, 7, 8, 31, 32, 100, 256, 513):
            assert elastic.shrink_batch_for_mesh(b, mesh) == \
                jax_elastic.shrink_batch_for_mesh(b, duck), (shape, b)


def test_remesh_onto_one_rank_without_a_group_keeps_the_tree():
    tree = {"w": torch.ones(4, 2), "step": torch.zeros((), dtype=torch.int32)}
    axes = {"w": ("embed", "ff"), "step": ()}
    mesh = tmesh.make_host_mesh()
    assert elastic.remesh_tree(tree, axes, mesh, tsh.default_rules()) is tree
    with pytest.raises(ValueError, match="DeviceMesh"):
        elastic.remesh_tree(tree, axes, tsh.Mesh(("data", "model"), (2, 1)),
                            tsh.default_rules())


def test_archs_are_the_reference_archs():
    assert sorted(ALL_ARCHS) == sorted(JAX_ARCHS)
