"""Tensor and expert parallelism across CPU ``gloo`` ranks, each rank
held against two programs of the JAX package: its one-device program
and its program on the same mesh, ``jax.make_mesh(shape, axes,
axis_types=(AxisType.Auto,) * n)`` over forced host devices, with the
state placed by ``tree_to_shardings`` under the rank body's rules
(``MESH_PROGRAMS``).  The reference's programs fail on JAX 0.9 only on
``jax.make_mesh``'s default ``Explicit`` axes (its tensor-parallel
forward at its vocab-sharded embedding gather); its launchers build
such meshes, so the launcher checks keep their one-rank yardstick.  Its
expert parallelism is held against its ``apply_moe_ep_shardmap`` on
forced host devices.

One JAX subprocess (4 forced host devices) computes every reference
output of the module; the ranks start once per mesh and run every
family; the checks are cases of parametrised tests over their results.
Reduced qwen3-0.6b (also with a vocabulary of 511 that does not divide,
so ``safe_spec`` replicates it, and with 6 query heads over 3 kv heads,
so the kv split cuts a head), granite-8b, granite-moe-1b-a400m,
whisper-small and internvl2-1b on a (1, 2) mesh, ``model_par=2``:

- forward logits within 3e-4 of the reference's forward (``LOGIT_TOL``
  of ``tests/test_torch_models.py``);
- prefill and 4 greedy decode steps, with an even slot count (the cache
  split by slots: decode combines the ranks' partial softmaxes) and an
  odd one (replicated): the tokens equal the reference's;
- one float32 train step from the reference's initial state: loss within
  1e-5 and gradient norm within 1e-4, relative; each leaf's first and
  second moments within 1e-4 of the leaf's largest (the moments carry
  each leaf's gradient); every replicated parameter equal on the two
  ranks after the AdamW step (a missing sum would let them drift);
- every rank's parameters the exact slices their specs name, and its
  prefill cache within 1e-4 of the slices of the reference's cache.

Against the mesh program, with the same tolerances: the logits, the
greedy tokens, the loss and gradient norm; each rank's parameters equal
to the block of the device at its mesh coordinates, its new parameters
within ``lr · (1e-3 + |Δm| / ((1 - b1) · eps))`` and its moments within
1e-4 of the leaf's largest of that device's blocks, its prefill cache
within 1e-4 of that device's block (the mesh program pins the cache to
its specs, as the reference's prefill cell does).

Expert parallelism: the port's ``apply_moe`` under ``{"experts":
"model", "expert_ff": "data"}`` on a (2, 2) mesh of 4 ranks against the
reference's ``apply_moe_ep_shardmap`` on 4 host devices, same numpy
inputs, within 1e-4 (the reference's own bound), and the two packages'
``_use_shardmap_ep`` over configs x rules x meshes.  ``sample_token``
over vocab shards that tie takes the first maximum.
"""
import json
import os
import textwrap

import numpy as np
import pytest

from test_torch_distributed_ranks import _ranks, _reference

LOGIT_TOL, CACHE_TOL, MOMENT_TOL = 3e-4, 1e-4, 1e-4
LOSS_RTOL, NORM_RTOL = 1e-5, 1e-4
B, S, STEPS = 2, 16, 4
TRAIN_B, TRAIN_S = 4, 16
TCFG = dict(learning_rate=1e-3, total_steps=50, warmup_steps=5, remat=True,
            compute_dtype="float32", grad_reduce_dtype="float32")
ODD_VOCAB = "qwen3-0.6b+v511"
# 6 query heads over 3 kv heads: each rank's 3 query heads read kv heads
# of two groups, one kv head a query head
ODD_GROUPS = "qwen3-0.6b+h6k3"
FAMILIES = ["qwen3-0.6b", ODD_VOCAB, ODD_GROUPS, "granite-8b",
            "granite-moe-1b-a400m", "whisper-small", "internvl2-1b"]

# --- shared by both packages' scripts: a family's config and inputs
_COMMON = """
import numpy as np

def config(name, get_arch):
    base, _, mod = name.partition("+")
    cfg = get_arch(base, reduced=True)
    if mod.startswith("v"):   # a vocabulary the model axis does not divide
        cfg = cfg.replace(vocab_size=int(mod[1:]), vocab_pad_multiple=1)
    elif mod.startswith("h"):  # other head counts: h<q heads>k<kv heads>
        h, k = mod[1:].split("k")
        cfg = cfg.replace(num_heads=int(h), num_kv_heads=int(k))
    return cfg

def extras(cfg, b, seed):
    rng = np.random.default_rng(100 + seed)
    out = {}
    if cfg.frontend == "vit_stub":
        out["patch_embeds"] = (rng.standard_normal(
            (b, cfg.num_patches, cfg.d_model)) * 0.1).astype(np.float32)
    if cfg.is_encoder_decoder:
        out["frames"] = (rng.standard_normal(
            (b, cfg.encoder_seq_len, cfg.d_model)) * 0.1).astype(np.float32)
    return out

def serve_batch(cfg):
    toks = np.random.default_rng(3).integers(1, cfg.vocab_size, (B, S))
    return {"tokens": toks.astype(np.int32), **extras(cfg, B, 0)}

def slots(cfg):
    lead = cfg.num_patches if cfg.frontend == "vit_stub" else 0
    even = lead + S + 8      # divides 2 and 4 ranks
    return even, even + 1

def flat(tree, prefix):
    out = {}
    def walk(p, node):
        if isinstance(node, dict):
            for k, v in sorted(node.items()):
                walk(p + "/" + k, v)
        else:
            out[p] = np.asarray(node, np.float32) if not hasattr(node, "detach") \\
                else node.detach().float().cpu().numpy()
    walk(prefix, tree)
    return out

def unflat(npz, prefix):
    root = {}
    for key in npz.files:
        if not key.startswith(prefix + "/"):
            continue
        node = root
        *head, last = key[len(prefix) + 1:].split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = npz[key]
    return root
"""


def _common():
    return f"B, S, STEPS = {B}, {S}, {STEPS}\n" + _COMMON


def mesh_tag(shape, kind="body"):
    """The name of a mesh program's outputs: ``1x2``, ``1x2-over``."""
    return "x".join(map(str, shape)) + ("" if kind == "body" else "-" + kind)


# --- the JAX package's programs on an Auto mesh (JAX 0.9 refuses its
# constraints on jax.make_mesh's default Explicit axes only).  ``kind``
# picks the rules of the port's rank body: "body" serves under the
# default rules and trains under the config's ``sharding_overrides``
# (``_RANK_BODY``); "over" serves under the ``sharding_overrides`` (the
# greedy tokens at the even slot count, as "tok_over", and the prefill
# cache); "zero3" trains under the ``train_sharding_overrides`` as well
# (``tests/test_torch_zero3.py``).  Each leaf's block on each device is
# saved as "<coordinates>:<key>", the device's mesh coordinates joined
# by dots ("0.1:p0/embed").
MESH_PROGRAMS = '''
from jax.sharding import AxisType, NamedSharding
from repro.distributed.sharding import safe_spec, tree_to_shardings
from repro.training.train_step import train_state_axes

def mesh_tag(shape, kind="body"):
    return "x".join(map(str, shape)) + ("" if kind == "body" else "-" + kind)

def auto_mesh(shape):
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    return jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes),
                         devices=jax.devices()[:int(np.prod(shape))])

def shards(tree, prefix, mesh):
    out = {}
    def walk(p, node):
        if isinstance(node, dict):
            for k, v in sorted(node.items()):
                walk(p + "/" + k, v)
            return
        full = np.asarray(node, np.float32)
        for s in node.addressable_shards:
            at = np.argwhere(mesh.devices == s.device)[0]
            out[".".join(map(str, at)) + ":" + p] = full[s.index]
    walk(prefix, tree)
    return out

def rows_on(batch, mesh, rules):
    return {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, safe_spec(
        v.shape, ("batch",) + (None,) * (v.ndim - 1), rules, mesh)))
        for k, v in batch.items()}

def mesh_program(cfg, api, params, b, tb, state, shape, kind, tcfg):
    mesh = auto_mesh(shape)
    over = dict(cfg.sharding_overrides or {})
    res = {}
    with mesh:
        if kind in ("body", "over"):
            rules = dict(default_rules(), **(over if kind == "over" else {}))
            sh = ShardingCtx(mesh=mesh, rules=rules)
            p = jax.device_put(params, tree_to_shardings(
                params, api.param_axes(), mesh, rules))
            jb = rows_on(b, mesh, rules)
            even, odd = slots(cfg)
            if kind == "body":
                logits, _ = jax.jit(lambda p, x: api.forward(p, x, sh))(p, jb)
                res["logits"] = np.asarray(logits)
                res.update(shards(p, "p0", mesh))
            runs = (("even", even), ("odd", odd)) if kind == "body" else \\
                (("over", even),)
            for tag, m in runs:
                res["tok_" + tag] = np.asarray(greedy_generate(
                    api, p, jb, steps=STEPS, sh=sh, max_cache=m))
            # the cache leaves placed as their specs name, as the JAX
            # package's prefill cell pins them (launch/dryrun.build_cell)
            fn = lambda p, x: api.prefill(p, x, sh, even)
            c_sh = tree_to_shardings(jax.eval_shape(fn, p, jb)[1],
                                     api.cache_axes(), mesh, rules)
            _, cache = jax.jit(fn, out_shardings=(None, c_sh))(p, jb)
            res.update(shards(cache, "cache", mesh))
        if kind in ("body", "zero3"):
            rules = dict(default_rules(), **over)
            if kind == "zero3":
                rules.update(cfg.train_sharding_overrides or {})
            sh = ShardingCtx(mesh=mesh, rules=rules)
            st_sh = tree_to_shardings(state, train_state_axes(api), mesh, rules)
            st = jax.device_put(state, st_sh)
            if kind == "zero3":
                res.update(shards(st["params"], "p0", mesh))
            step = jax.jit(make_train_step(api, tcfg, sh),
                           in_shardings=(st_sh, None),
                           out_shardings=(st_sh, None))
            new, met = step(st, rows_on(tb, mesh, rules))
            res.update(loss=float(met["loss"]), gnorm=float(met["grad_norm"]),
                       lr=float(met["lr"]))
            for leaf, key in (("params", "p1"), ("m", "m1"), ("v", "v1")):
                res.update(shards(new[leaf], key, mesh))
    return res
'''


def reference_outputs(out_dir, families, ep=False, meshes=(), devices=4,
                      timeout=300):
    """The reference's outputs of every family in one JAX process, one
    ``<family>.npz`` each: the initial params, the forward logits, the
    greedy tokens, the prefill cache at the even slot count, the train
    batch, the initial train state, and the step's loss, gradient norm
    and moments.  ``meshes`` lists ``(family, mesh shape, kind)``: the
    same programs on an ``Auto`` mesh of that shape (``MESH_PROGRAMS``),
    one ``<family>@<mesh_tag>.npz`` each.  With ``ep``, also ``ep.npz``
    (the EP route on a (2, 2) mesh) and ``ep.json``
    (``_use_shardmap_ep``'s choices)."""
    code = _common() + MESH_PROGRAMS + f"""
import json, jax, jax.numpy as jnp
from repro.configs import get_arch
from repro.dataio import lm_token_stream
from repro.distributed.sharding import REPLICATED, ShardingCtx, default_rules
from repro.models import get_model
from repro.serving.serve_step import greedy_generate
from repro.training import TrainConfig, make_train_step
from repro.training.train_step import init_train_state
OUT = {str(out_dir)!r}
for name in {list(families)!r}:
    cfg = config(name, get_arch)
    api = get_model(cfg)
    params = api.init(jax.random.PRNGKey(7))
    b = serve_batch(cfg)
    jb = {{k: jnp.asarray(v) for k, v in b.items()}}
    logits, _ = api.forward(params, jb, REPLICATED)
    even, odd = slots(cfg)
    toks = greedy_generate(api, params, jb, steps=STEPS, sh=REPLICATED,
                           max_cache=even)
    _, cache = api.prefill(params, jb, REPLICATED, even)
    tb = {{"tokens": lm_token_stream({TRAIN_B}, {TRAIN_S}, cfg.vocab_size, 0),
           **extras(cfg, {TRAIN_B}, 1)}}
    state = init_train_state(api, jax.random.PRNGKey(0))
    step = jax.jit(make_train_step(api, TrainConfig(**{TCFG!r}), REPLICATED))
    new, met = step(state, {{k: jnp.asarray(v) for k, v in tb.items()}})
    np.savez(OUT + "/" + name + ".npz", logits=np.asarray(logits),
             tokens=np.asarray(toks), loss=float(met["loss"]),
             gnorm=float(met["grad_norm"]),
             **{{"b/" + k: v for k, v in b.items()}},
             **{{"tb/" + k: np.asarray(v) for k, v in tb.items()}},
             **flat(params, "params"), **flat(cache, "cache"),
             **flat(state["params"], "s/params"), **flat(state["m"], "s/m"),
             **flat(state["v"], "s/v"), **flat(new["m"], "m1"),
             **flat(new["v"], "v1"), **{{"s/step": np.asarray(state["step"])}})
    for shape, kind in [(tuple(s), k) for f, s, k in {list(meshes)!r}
                        if f == name]:
        np.savez(OUT + "/" + name + "@" + mesh_tag(shape, kind) + ".npz",
                 **mesh_program(cfg, api, params, b, tb, state, shape, kind,
                                TrainConfig(**{TCFG!r})))
if {ep!r}:
    from repro.models.moe import apply_moe, init_moe, _use_shardmap_ep
    from repro.models.common import KeyGen
    cfg = get_arch("granite-moe-1b-a400m", reduced=True)
    rules = dict(default_rules(), experts="model", expert_ff="data")
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    p = init_moe(KeyGen(jax.random.PRNGKey(0)), cfg, jnp.float32)
    x = np.random.default_rng(1).standard_normal((4, 16, cfg.d_model))
    x = (x * 0.5).astype(np.float32)
    with mesh:
        y, aux = jax.jit(lambda p, x: apply_moe(
            p, x, cfg=cfg, sh=ShardingCtx(mesh=mesh, rules=rules)))(
                p, jnp.asarray(x))
    np.savez(OUT + "/ep.npz", x=x, y=np.asarray(y), aux=float(aux),
             **{{"p/" + k: np.asarray(v) for k, v in p.items()}})

    class Duck:     # the spec arithmetic's mesh: names and a shape
        def __init__(self, shape):
            self.axis_names = ("data", "model")
            self.devices = np.empty(shape)
    picks = {{}}
    for arch in ("granite-moe-1b-a400m", "qwen3-moe-235b-a22b"):
        for full in (False, True):
            c = get_arch(arch, reduced=not full)
            for key, over in EP_RULES.items():
                r = dict(default_rules(), **over)
                for shape in EP_MESHES:
                    picks[f"{{arch}}|{{full}}|{{key}}|{{shape}}"] = \\
                        _use_shardmap_ep(c, ShardingCtx(mesh=Duck(shape),
                                                        rules=r))
    json.dump(picks, open(OUT + "/ep.json", "w"))
"""
    code = code.replace("EP_RULES", repr(EP_RULES)).replace(
        "EP_MESHES", repr(EP_MESHES))
    _reference(devices, code, timeout=timeout)


EP_RULES = {"default": {}, "ep": {"experts": "model", "expert_ff": "data"},
            "experts_only": {"experts": "model"}}
EP_MESHES = [(1, 1), (2, 2), (1, 3), (2, 4), (16, 16)]

# --- what every rank runs for each family
_RANK_BODY = """
from repro_torch.configs import get_arch
from repro_torch.distributed.sharding import (Layout, ShardingCtx,
                                              default_rules, local_rows)
from repro_torch.interop import params_from_jax, train_state_from_jax
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import get_model
from repro_torch.models.registry import vocab_split
from repro_torch.serving.serve_step import greedy_generate
from repro_torch.training import TrainConfig, make_train_step
mesh = make_host_mesh(model=MESH[1])
assert mesh.shape == MESH, mesh.shape

def full_rows(sh, x, n):
    return sh.gather(x, 0, axis="data") if n > 1 else x

for name in FAMILIES:
    cfg = config(name, get_arch)
    api = get_model(cfg)
    ref = np.load(os.path.join(REF, name + ".npz"))
    sh = ShardingCtx(mesh=mesh)
    res = {}
    params = params_from_jax(unflat(ref, "params"), cfg, "cpu", mesh)
    res.update(flat(params, "p0"))
    b = {k: torch.from_numpy(v) for k, v in unflat(ref, "b").items()}
    n = mesh.batch_extent
    rows = local_rows(b, n, sh.data_index)
    with torch.no_grad():
        logits, _ = api.forward(params, rows, sh)
        if vocab_split(cfg, sh) is not None:
            logits = sh.gather(logits, -1)
        res["logits"] = full_rows(sh, logits, n).numpy()
        even, odd = slots(cfg)
        for tag, m in (("even", even), ("odd", odd)):
            toks = greedy_generate(api, params, rows, steps=STEPS, sh=sh,
                                   max_cache=m)
            res["tok_" + tag] = full_rows(sh, toks, n).numpy()
        _, cache = api.prefill(params, rows, sh, even)
        res.update(flat(dict(cache), "cache"))
    rules = dict(default_rules(), **(cfg.sharding_overrides or {}))
    tsh = ShardingCtx(mesh=mesh, rules=rules)
    state = train_state_from_jax(unflat(ref, "s"), cfg, "cpu", mesh, rules)
    step = make_train_step(api, TrainConfig(**TCFG), tsh)
    tb = {k: torch.from_numpy(v) for k, v in unflat(ref, "tb").items()}
    state, met = step(state, tb)
    res.update(flat(state["params"], "p1"))
    res.update(flat(state["m"], "m1"))
    res.update(flat(state["v"], "v1"))
    res["loss"], res["gnorm"] = float(met["loss"]), float(met["grad_norm"])
    np.savez(os.path.join(out, f"{name}_{rank}.npz"), **res)
"""


def run_families(tmp, ref_dir, families, n, mesh_shape, extra=""):
    body = (_common() + f"\nREF = {str(ref_dir)!r}\nFAMILIES = {families!r}"
            f"\nTCFG = {TCFG!r}\nMESH = {mesh_shape!r}\n" + _RANK_BODY
            + textwrap.dedent(extra))
    return _ranks(tmp, n, body, timeout=240)


# ------------------------------------------------------------- checks
def _spec_slice(full, spec, coords, sizes):
    """The block of ``full`` that ``spec`` gives the rank at ``coords``
    (numpy; independent of the port's ``local_shard``)."""
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        names = (entry,) if isinstance(entry, str) else entry
        n = int(np.prod([sizes[a] for a in names]))
        i = 0
        for a in names:
            i = i * sizes[a] + coords[a]
        per = full.shape[d] // n
        full = np.take(full, np.arange(i * per, (i + 1) * per), axis=d)
    return full


def _specs(name, tree_kind, mesh_shape, rules_of="serve"):
    """{path: (batch dim or None, spec)} of a family's parameter or cache
    tree on a ``(data, model)`` mesh of ``mesh_shape`` (the port's spec
    arithmetic, which ``tests/test_torch_distributed.py`` holds against
    the reference's); a cache's specs are those of one data index's
    rows."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed.sharding import (Mesh, default_rules,
                                                  map_with_axes,
                                                  tree_to_specs)
    from repro_torch.models import get_model
    from repro_torch.models.registry import param_shapes
    ns = {}
    exec(_common(), ns)
    cfg = ns["config"](name, get_arch)
    api = get_model(cfg)
    rules = default_rules()
    if rules_of == "train":
        rules.update(cfg.sharding_overrides or {})
    mesh = Mesh(("data", "model"), mesh_shape)
    if tree_kind == "params":
        shapes, axes = param_shapes(api), api.param_axes()
    else:
        shapes = api.init_cache(B // mesh_shape[0], ns["slots"](cfg)[0],
                                device="meta")
        axes = api.cache_axes()
    specs = tree_to_specs(shapes, axes, mesh, rules)
    pairs = map_with_axes(lambda spec, ax: (
        ax.index("batch") if ax and "batch" in ax else None, spec),
        specs, axes)
    out = {}

    def walk(p, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(p + "/" + k, v)
        else:
            out[p] = node
    walk(tree_kind, pairs)
    return out


def _coords(rank, mesh_shape):
    return {"data": rank // mesh_shape[1], "model": rank % mesh_shape[1]}


def check_forward(ref_dir, out_dir, name, n):
    ref = np.load(os.path.join(ref_dir, name + ".npz"))
    for r in range(n):
        got = np.load(os.path.join(out_dir, f"{name}_{r}.npz"))["logits"]
        np.testing.assert_allclose(got, ref["logits"], atol=LOGIT_TOL, rtol=0,
                                   err_msg=f"{name} rank {r}")


def check_greedy(ref_dir, out_dir, name, n, tag):
    ref = np.load(os.path.join(ref_dir, name + ".npz"))
    for r in range(n):
        got = np.load(os.path.join(out_dir, f"{name}_{r}.npz"))["tok_" + tag]
        np.testing.assert_array_equal(got, ref["tokens"],
                                      err_msg=f"{name} rank {r} ({tag})")


def check_train_step(ref_dir, out_dir, name, n, mesh_shape):
    ref = np.load(os.path.join(ref_dir, name + ".npz"))
    specs = {p: spec for p, (_, spec) in
             _specs(name, "params", mesh_shape, "train").items()}
    outs = [np.load(os.path.join(out_dir, f"{name}_{r}.npz"))
            for r in range(n)]
    for r, got in enumerate(outs):
        np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]),
                                   rtol=LOSS_RTOL, err_msg=f"rank {r}")
        np.testing.assert_allclose(float(got["gnorm"]), float(ref["gnorm"]),
                                   rtol=NORM_RTOL, err_msg=f"rank {r}")
        coords = _coords(r, mesh_shape)
        sizes = dict(zip(("data", "model"), mesh_shape))
        for kind in ("m1", "v1"):
            for path, spec in specs.items():
                key = kind + path[len("params"):]
                want = _spec_slice(ref[key], spec, coords, sizes)
                tol = MOMENT_TOL * max(float(np.abs(ref[key]).max()), 1e-30)
                np.testing.assert_allclose(got[key], want, atol=tol, rtol=0,
                                           err_msg=f"{key} rank {r}")
    replicated = [p for p, spec in specs.items() if not any(spec)]
    assert replicated
    for path in replicated:
        key = "p1" + path[len("params"):]
        for r in range(1, n):
            np.testing.assert_array_equal(outs[r][key], outs[0][key],
                                          err_msg=f"{key}: rank {r} drifted")


def check_shards(ref_dir, out_dir, name, n, mesh_shape):
    ref = np.load(os.path.join(ref_dir, name + ".npz"))
    sizes = dict(zip(("data", "model"), mesh_shape))
    p_specs = _specs(name, "params", mesh_shape)
    c_specs = _specs(name, "cache", mesh_shape)
    split = 0
    for r in range(n):
        got = np.load(os.path.join(out_dir, f"{name}_{r}.npz"))
        coords = _coords(r, mesh_shape)
        for path, (_, spec) in p_specs.items():
            key = "p0" + path[len("params"):]
            want = _spec_slice(ref[path], spec, coords, sizes)
            np.testing.assert_array_equal(got[key], want, err_msg=key)
            split += any(spec)
        for path, (bdim, spec) in c_specs.items():
            # the reference's cache holds every row: this rank's rows are
            # its data index's block, then its spec's model blocks
            want = _spec_slice(ref[path], [None] * bdim + ["data"], coords,
                               sizes)
            want = _spec_slice(want, [e if e == "model" else None
                                      for e in spec], coords, sizes)
            np.testing.assert_allclose(got[path], want, atol=CACHE_TOL,
                                       rtol=0, err_msg=f"{path} rank {r}")
    assert split, "no parameter is split"


# ------------------------------------ checks against the mesh programs
def mesh_outputs(ref_dir, name, shape, kind="body"):
    return np.load(os.path.join(ref_dir, f"{name}@{mesh_tag(shape, kind)}.npz"))


def rank_at(rank, shape):
    """The rank's mesh coordinates, as the mesh program's keys write them
    (the port's meshes are row-major over the ranks)."""
    return ".".join(str(int(i)) for i in np.unravel_index(rank, shape))


def device_blocks(mesh_out, rank, shape, prefix):
    """{key: block} of the device at the rank's coordinates, over the
    keys under ``prefix`` ("p0", "cache", ...)."""
    at = rank_at(rank, shape) + ":"
    return {k[len(at):]: mesh_out[k] for k in mesh_out.files
            if k.startswith(at + prefix + "/")}


def check_mesh_forward(ref_dir, out_dir, name, shape):
    want = mesh_outputs(ref_dir, name, shape)["logits"]
    for r in range(int(np.prod(shape))):
        got = np.load(os.path.join(out_dir, f"{name}_{r}.npz"))["logits"]
        np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0,
                                   err_msg=f"{name} rank {r}")


def check_mesh_greedy(ref_dir, out_dir, name, shape, tag, kind="body",
                      stem=None):
    want = mesh_outputs(ref_dir, name, shape, kind)["tok_" + tag]
    for r in range(int(np.prod(shape))):
        got = np.load(os.path.join(out_dir, f"{stem or name}_{r}.npz"))
        np.testing.assert_array_equal(got["tok_" + tag], want,
                                      err_msg=f"{name} rank {r} ({tag})")


def check_mesh_train_step(ref_dir, out_dir, name, shape, kind="body",
                          stem=None, keys=None):
    """Loss and gradient norm (``LOSS_RTOL``, ``NORM_RTOL``), and each
    rank's moments and new parameters against the blocks of the device at
    its coordinates: the moments within ``MOMENT_TOL`` of the leaf's
    largest, the parameters within ``lr · (1e-3 + |Δm| / ((1 - b1) ·
    eps))`` (AdamW's first step moves an element by ``lr · g / (|g| +
    eps)``, whose slope is 1/eps; ``tests/test_torch_training.py``).
    ``keys`` maps the mesh program's "p1", "m1", "v1" to the rank's."""
    from repro_torch.training import TrainConfig
    tcfg = TrainConfig(**TCFG)
    mesh = mesh_outputs(ref_dir, name, shape, kind)
    keys = keys or {k: k for k in ("p1", "m1", "v1")}
    top = {}
    for k in mesh.files:
        if ":" in k:
            leaf = k.split(":", 1)[1]
            top[leaf] = max(top.get(leaf, 0.0), float(np.abs(mesh[k]).max()))
    for r in range(int(np.prod(shape))):
        got = np.load(os.path.join(out_dir, f"{stem or name}_{r}.npz"))
        np.testing.assert_allclose(float(got["loss"]), float(mesh["loss"]),
                                   rtol=LOSS_RTOL, err_msg=f"rank {r}")
        np.testing.assert_allclose(float(got["gnorm"]), float(mesh["gnorm"]),
                                   rtol=NORM_RTOL, err_msg=f"rank {r}")
        blocks = {kind_: device_blocks(mesh, r, shape, kind_)
                  for kind_ in ("p1", "m1", "v1")}
        assert blocks["p1"] and set(blocks["p1"]) == {
            "p1" + k[2:] for k in blocks["m1"]}
        for kind_ in ("m1", "v1"):
            for key, want in blocks[kind_].items():
                mine = got[keys[kind_] + key[2:]]
                assert mine.shape == want.shape, (key, r, mine.shape,
                                                  want.shape)
                np.testing.assert_allclose(
                    mine, want, atol=MOMENT_TOL * max(top[key], 1e-30),
                    rtol=0, err_msg=f"{key} rank {r}")
        for key, want in blocks["p1"].items():
            path = key[2:]
            dm = np.abs(got[keys["m1"] + path] - blocks["m1"]["m1" + path])
            allowed = float(mesh["lr"]) * (
                1e-3 + dm / ((1 - tcfg.b1) * tcfg.eps)) + 1e-7
            mine = got[keys["p1"] + path]
            assert mine.shape == want.shape, (key, r)
            assert np.all(np.abs(mine - want) <= allowed), (key, r)


def check_mesh_shards(ref_dir, out_dir, name, shape, kind="body", stem=None,
                      prefixes=("p0", "cache")):
    """Each rank's parameters equal the block of the device at its
    coordinates, and its prefill cache lies within ``CACHE_TOL`` of it:
    the same shape, so the rank holds what the device holds."""
    mesh = mesh_outputs(ref_dir, name, shape, kind)
    for prefix in prefixes:
        seen = 0
        for r in range(int(np.prod(shape))):
            got = np.load(os.path.join(out_dir, f"{stem or name}_{r}.npz"))
            for key, want in device_blocks(mesh, r, shape, prefix).items():
                seen += 1
                assert got[key].shape == want.shape, (
                    f"{key} rank {r}: {got[key].shape} against the device's "
                    f"{want.shape}")
                if prefix == "p0":
                    np.testing.assert_array_equal(got[key], want,
                                                  err_msg=f"{key} rank {r}")
                else:
                    np.testing.assert_allclose(got[key], want, atol=CACHE_TOL,
                                               rtol=0,
                                               err_msg=f"{key} rank {r}")
        assert seen, prefix


# ------------------------------------------------------------ fixtures
@pytest.fixture(scope="module")
def ref_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_ref")
    reference_outputs(d, FAMILIES, ep=True,
                      meshes=[(f, (1, 2), "body") for f in FAMILIES])
    return d


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, ref_dir):
    tmp = tmp_path_factory.mktemp("tp_ranks")
    run_families(tmp, ref_dir, FAMILIES, 2, (1, 2), extra="""
        # sample_token over vocab shards that tie: the first maximum
        from repro_torch.serving.serve_step import sample_token
        full = torch.zeros(3, 8)
        full[0, 1] = full[0, 6] = 5.0       # a tie across the shards
        full[1, 5] = full[1, 7] = 2.0       # a tie inside rank 1's shard
        full[2, :] = -1.0                   # every slot ties
        got = sample_token(full[:, rank * 4:(rank + 1) * 4],
                           sh=ShardingCtx(mesh=mesh), vocab_size=8)
        np.save(os.path.join(out, f"argmax_{rank}.npy"), got.numpy())
    """)
    return tmp


@pytest.fixture(scope="module")
def ep_ranks(tmp_path_factory, ref_dir):
    tmp = tmp_path_factory.mktemp("ep_ranks")
    _ranks(tmp, 4, f"""
        from repro_torch.configs import get_arch
        from repro_torch.distributed.sharding import (Layout, ShardingCtx,
                                                      default_rules)
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.models import moe
        cfg = get_arch("granite-moe-1b-a400m", reduced=True)
        mesh = make_host_mesh(model=2)
        rules = dict(default_rules(), experts="model", expert_ff="data")
        sh = ShardingCtx(mesh=mesh, rules=rules)
        assert moe._use_shardmap_ep(cfg, sh)
        ref = np.load(os.path.join({str(ref_dir)!r}, "ep.npz"))
        full = {{k[2:]: torch.from_numpy(ref[k]) for k in ref.files
                if k.startswith("p/")}}
        p = Layout(sh, full, moe.axes_moe(cfg)).local(full)
        assert p["w_gate"].shape == (4, cfg.d_model, cfg.d_ff // 2)
        x = torch.from_numpy(ref["x"])[2 * sh.data_index:2 * sh.data_index + 2]
        y, aux = moe.apply_moe(p, x, cfg=cfg, sh=sh)
        y = sh.gather(y, 0, axis="data")
        np.savez(os.path.join(out, f"ep_{{rank}}.npz"), y=y.numpy(),
                 aux=float(aux))
    """, timeout=240)
    return tmp


# --------------------------------------------------------------- tests
@pytest.mark.parametrize("name", FAMILIES)
def test_tp_forward_logits_match_the_reference(ref_dir, two_ranks, name):
    check_forward(ref_dir, two_ranks, name, 2)


@pytest.mark.parametrize("tag", ["even", "odd"])
@pytest.mark.parametrize("name", FAMILIES)
def test_tp_greedy_tokens_match_the_reference(ref_dir, two_ranks, name, tag):
    check_greedy(ref_dir, two_ranks, name, 2, tag)


@pytest.mark.parametrize("name", FAMILIES)
def test_tp_train_step_matches_the_reference(ref_dir, two_ranks, name):
    check_train_step(ref_dir, two_ranks, name, 2, (1, 2))


@pytest.mark.parametrize("name", FAMILIES)
def test_tp_local_shards_are_their_spec_slices(ref_dir, two_ranks, name):
    check_shards(ref_dir, two_ranks, name, 2, (1, 2))


@pytest.mark.parametrize("name", FAMILIES)
def test_tp_forward_logits_match_the_mesh_program(ref_dir, two_ranks, name):
    check_mesh_forward(ref_dir, two_ranks, name, (1, 2))


@pytest.mark.parametrize("tag", ["even", "odd"])
@pytest.mark.parametrize("name", FAMILIES)
def test_tp_greedy_tokens_match_the_mesh_program(ref_dir, two_ranks, name,
                                                 tag):
    check_mesh_greedy(ref_dir, two_ranks, name, (1, 2), tag)


@pytest.mark.parametrize("name", FAMILIES)
def test_tp_train_step_matches_the_mesh_program(ref_dir, two_ranks, name):
    check_mesh_train_step(ref_dir, two_ranks, name, (1, 2))


@pytest.mark.parametrize("name", FAMILIES)
def test_tp_local_shards_are_the_mesh_programs_shards(ref_dir, two_ranks,
                                                      name):
    check_mesh_shards(ref_dir, two_ranks, name, (1, 2))


def test_sample_token_over_vocab_shards_takes_the_first_maximum(two_ranks):
    import torch
    full = torch.zeros(3, 8)
    full[0, 1] = full[0, 6] = 5.0
    full[1, 5] = full[1, 7] = 2.0
    full[2, :] = -1.0
    want = torch.argmax(full, dim=-1, keepdim=True).numpy()
    for r in range(2):
        np.testing.assert_array_equal(
            np.load(two_ranks / f"argmax_{r}.npy"), want)


def test_ep_route_matches_the_reference_shardmap(ref_dir, ep_ranks):
    ref = np.load(ref_dir / "ep.npz")
    for r in range(4):
        got = np.load(ep_ranks / f"ep_{r}.npz")
        np.testing.assert_allclose(got["y"], ref["y"], atol=1e-4, rtol=0,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(float(got["aux"]), float(ref["aux"]),
                                   atol=1e-6)


def test_use_shardmap_ep_decides_as_the_reference(ref_dir):
    from repro_torch.configs import get_arch
    from repro_torch.distributed.sharding import (Mesh, ShardingCtx,
                                                  default_rules)
    from repro_torch.models.moe import _use_shardmap_ep
    want = json.load(open(ref_dir / "ep.json"))
    got = {}
    for arch in ("granite-moe-1b-a400m", "qwen3-moe-235b-a22b"):
        for full in (False, True):
            c = get_arch(arch, reduced=not full)
            for key, over in EP_RULES.items():
                rules = dict(default_rules(), **over)
                for shape in EP_MESHES:
                    sh = ShardingCtx(mesh=Mesh(("data", "model"), shape),
                                     rules=rules)
                    got[f"{arch}|{full}|{key}|{shape}"] = \
                        _use_shardmap_ep(c, sh)
    assert got == want
    assert any(want.values()) and not all(want.values())
