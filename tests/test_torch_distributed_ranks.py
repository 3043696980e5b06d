"""The distribution substrate across ranks: CPU ``gloo`` process groups
in subprocesses (a ``file://`` store under ``tmp_path``, one thread a
rank, a timeout on every run), against the JAX package on forced host
devices (``XLA_FLAGS=--xla_force_host_platform_device_count=N``, the
recipe of ``tests/test_distributed.py``) and against the port's own
one-rank runs.

- The int8 compressed reducer on 8 ranks against the reference's
  ``make_compressed_grad_reducer`` on 8 devices, same numpy rows,
  including a leaf whose size needs padding: within two int8 steps of
  the rows' largest magnitude (the two packages quantize the same
  values; a float32 division landing on the other side of a rounding
  boundary moves one value by one step of either phase), and within
  2e-2 of the true mean (the reference's own bound).
- ``elastic.remesh_tree`` on a (2, 2) mesh: every rank's local shard is
  the slice of the full tensor that its spec names.
- Data-parallel training of reduced qwen3-0.6b, 8 rows as 2
  microbatches of 4 (so each of 4 ranks takes one row of each): (a) the
  port's two train steps on 4 ranks from the reference's initial state
  against the reference's jitted step on one device and on an ``Auto``
  (4, 1) mesh as its launcher builds it (state placed by
  ``tree_to_shardings``, shardings in and out; the reference fails only
  on ``jax.make_mesh``'s default ``Explicit`` axes), float32 compute and
  reduction: losses 1e-5 and gradient norms 1e-4 relative (float32 sums
  in other orders, as the one-device parity tests), and each rank's
  state before and after the first step against the mesh program's
  device at its coordinates; (b) ``launch.train.run`` on 4 ranks against
  its one-rank run of the same global batches: the same tolerances (the
  reference's launcher builds an ``Explicit`` mesh).
- ``launch.model_serve.run`` on 2 ranks: the greedy tokens equal the
  one-rank run's.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL, NORM_RTOL = 1e-5, 1e-4

_RANK_PRELUDE = """
import json, os, sys
sys.path.insert(0, {src!r})
rank, world, store, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world)
try:
{body}
    dist.barrier()
finally:
    dist.destroy_process_group()
"""


def _ranks(tmp_path, n, body, timeout=240):
    """Run ``body`` on ``n`` gloo ranks; each may write under ``out``
    (``tmp_path``).  Fails with every rank's output if any rank fails."""
    script = tmp_path / f"ranks_{n}.py"
    script.write_text(_RANK_PRELUDE.format(
        src=os.path.join(ROOT, "src"),
        body=textwrap.indent(textwrap.dedent(body), "    ")))
    store = tmp_path / f"store_{n}"
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "PYTHONPATH")}
    env.update(OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(n), str(store),
         str(tmp_path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=ROOT) for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    codes = [p.returncode for p in procs]
    assert codes == [0] * n, "\n".join(f"rank {r} ({c}):\n{o[-3000:]}"
                                       for r, (c, o) in
                                       enumerate(zip(codes, outs)))
    return outs


def _reference(devices, code, timeout=300):
    """``code`` in a JAX process with ``devices`` forced host devices."""
    pre = (f'import os; os.environ["XLA_FLAGS"] = '
           f'"--xla_force_host_platform_device_count={devices}"\n'
           f'import sys; sys.path.insert(0, "src")\n')
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", pre + textwrap.dedent(code)],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=timeout, env=env)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    return out.stdout


# --------------------------------------------------------- the reducer
def test_compressed_reducer_on_8_ranks_matches_the_reference(tmp_path):
    rng = np.random.default_rng(0)
    rows = {"w": rng.standard_normal((8, 7, 5)).astype(np.float32),
            "b": (rng.standard_normal((8, 3, 3)) * 3).astype(np.float32)}
    np.savez(tmp_path / "rows.npz", **rows)       # 35 and 9: 9 pads to 16
    _reference(8, f"""
        import jax, numpy as np
        from jax.sharding import NamedSharding, PartitionSpec as P
        from repro.distributed.compression import make_compressed_grad_reducer
        mesh = jax.make_mesh((8,), ("data",))
        rows = dict(np.load({str(tmp_path / "rows.npz")!r}))
        red = make_compressed_grad_reducer(mesh, "data")
        out = red({{k: jax.device_put(v, NamedSharding(mesh, P("data")))
                   for k, v in rows.items()}})
        np.savez({str(tmp_path / "ref.npz")!r},
                 **{{k: np.asarray(v) for k, v in out.items()}})
    """)
    _ranks(tmp_path, 8, """
        from repro_torch.distributed.compression import (
            make_compressed_grad_reducer)
        from repro_torch.launch.mesh import make_host_mesh
        mesh = make_host_mesh()
        assert mesh.shape == (8, 1) and mesh.device_mesh is not None
        rows = dict(np.load(os.path.join(out, "rows.npz")))
        red = make_compressed_grad_reducer(mesh, "data")
        got = red({k: torch.from_numpy(v[rank:rank + 1])
                   for k, v in rows.items()})
        np.savez(os.path.join(out, f"port_{rank}.npz"),
                 **{k: v.numpy() for k, v in got.items()})
    """)
    ref = np.load(tmp_path / "ref.npz")
    for r in range(8):
        got = np.load(tmp_path / f"port_{r}.npz")
        for k, x in rows.items():
            step = np.abs(x).max() / 127
            assert got[k].shape == (1,) + x.shape[1:]
            np.testing.assert_allclose(got[k][0], ref[k][r], rtol=0,
                                       atol=2 * step, err_msg=k)
            want = x.mean(0)
            rel = np.abs(got[k][0] - want).max() / np.abs(want).max()
            assert rel < 0.02, (k, rel)


# --------------------------------------------------------------- remesh
def test_remesh_tree_on_a_2x2_mesh_gives_each_rank_its_slice(tmp_path):
    _ranks(tmp_path, 4, """
        from repro_torch.distributed.elastic import remesh_tree
        from repro_torch.distributed.sharding import default_rules, safe_spec
        from repro_torch.launch.mesh import make_host_mesh
        mesh = make_host_mesh(model=2)
        assert mesh.shape == (2, 2)
        g = torch.Generator().manual_seed(0)
        tree = {"w": torch.randn(8, 6, generator=g),
                "b": torch.randn(5, generator=g),
                "e": {"x": torch.randn(4, 6, 4, generator=g)},
                "step": torch.zeros((), dtype=torch.int32)}
        axes = {"w": ("batch", "ff"), "b": ("ff",),
                "e": {"x": ("experts", "embed", "vocab")}, "step": ()}
        rules = default_rules()
        out_tree = remesh_tree(tree, axes, mesh, rules)
        coord = {"data": rank // 2, "model": rank % 2}
        sizes = mesh.sizes

        def check(full, dt, ax):
            spec = safe_spec(full.shape, ax, rules, mesh)
            want = full
            for d, entry in enumerate(spec):
                if entry is None:
                    continue
                names = (entry,) if isinstance(entry, str) else entry
                assert len(names) == 1
                n, i = sizes[names[0]], coord[names[0]]
                per = full.shape[d] // n
                want = want.narrow(d, i * per, per)
            assert torch.equal(dt.to_local(), want), (ax, spec)
            return str(spec)

        specs = [check(tree["w"], out_tree["w"], axes["w"]),
                 check(tree["b"], out_tree["b"], axes["b"]),
                 check(tree["e"]["x"], out_tree["e"]["x"], axes["e"]["x"]),
                 check(tree["step"], out_tree["step"], ())]
        assert specs == ["P('data', 'model')", "P()", "P('data', None, 'model')",
                         "P()"], specs
        print("REMESH_OK")
    """)


# ------------------------------------------------------------- training
TRAIN_KW = dict(batch=8, seq=16, microbatches=2, steps=2)
TCFG = dict(learning_rate=3e-3, total_steps=2, warmup_steps=5,
            compute_dtype="float32", grad_reduce_dtype="float32",
            microbatches=2, remat=True)


DP_ARCH, DP_MESH = "qwen3-0.6b", (4, 1)


def _reference_steps(out_dir):
    """In one JAX process with 4 forced host devices, from the reference's
    seeded state (written to ``state.npz``, leaves by "/"-joined path):
    two float32 steps of its jitted train step on one device, and the same
    two steps on an ``Auto`` (4, 1) mesh as its launcher builds them (the
    state placed by ``tree_to_shardings``, the step jitted with those
    shardings in and out).  ``ref.json`` holds both runs' losses and
    gradient norms; the mesh program's outputs file, as
    ``tests/test_torch_tensor_parallel.py``'s mesh programs write them,
    each device's blocks of the state it starts from ("p0") and of the
    state after the first step ("p1", "m1", "v1"), and that step's loss,
    gradient norm and learning rate."""
    from test_torch_tensor_parallel import MESH_PROGRAMS
    _reference(4, MESH_PROGRAMS + textwrap.dedent(f"""
        import json, jax, jax.numpy as jnp, numpy as np
        from repro.configs import get_arch
        from repro.distributed.sharding import (REPLICATED, ShardingCtx,
                                                default_rules,
                                                tree_to_shardings)
        from repro.launch.train import make_batch_fn
        from repro.models import get_model
        from repro.training import TrainConfig, make_train_step
        from repro.training.train_step import init_train_state
        OUT = {str(out_dir)!r}
        cfg = get_arch({DP_ARCH!r}, reduced=True)
        model = get_model(cfg)
        state = init_train_state(model, jax.random.PRNGKey(0))
        np.savez(OUT + "/state.npz", **{{
            "/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(state)[0]}})
        make = make_batch_fn(cfg, {TRAIN_KW["batch"]}, {TRAIN_KW["seq"]})
        tcfg = TrainConfig(**{TCFG!r})
        runs = {{}}
        step = jax.jit(make_train_step(model, tcfg, REPLICATED))
        st, runs["one"] = state, ([], [])
        for i in range({TRAIN_KW["steps"]}):
            st, m = step(st, {{k: jnp.asarray(v) for k, v in make(i).items()}})
            runs["one"][0].append(float(m["loss"]))
            runs["one"][1].append(float(m["grad_norm"]))

        mesh = auto_mesh({DP_MESH!r})
        rules = dict(default_rules(), **(cfg.sharding_overrides or {{}}))
        st_sh = tree_to_shardings(state, train_state_axes(model), mesh, rules)
        res, runs["mesh"] = {{}}, ([], [])
        with mesh:
            st = jax.device_put(state, st_sh)
            res.update(shards(st["params"], "p0", mesh))
            step = jax.jit(make_train_step(model, tcfg,
                                           ShardingCtx(mesh=mesh, rules=rules)),
                           in_shardings=(st_sh, None),
                           out_shardings=(st_sh, None))
            for i in range({TRAIN_KW["steps"]}):
                st, m = step(st, {{k: jnp.asarray(v)
                                   for k, v in make(i).items()}})
                runs["mesh"][0].append(float(m["loss"]))
                runs["mesh"][1].append(float(m["grad_norm"]))
                if i == 0:
                    res.update(loss=float(m["loss"]), lr=float(m["lr"]),
                               gnorm=float(m["grad_norm"]))
                    for leaf, key in (("params", "p1"), ("m", "m1"),
                                      ("v", "v1")):
                        res.update(shards(st[leaf], key, mesh))
        np.savez(OUT + "/" + {DP_ARCH!r} + "@" + mesh_tag({DP_MESH!r})
                 + ".npz", **res)
        json.dump(runs, open(OUT + "/ref.json", "w"))
    """))
    return json.load(open(out_dir / "ref.json"))


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """The reference's runs (``_reference_steps``), then the port's train
    step on 4 ranks from the reference's initial state (each rank writes
    its losses and gradient norms, the launcher's, and, as the mesh
    checks read them, its blocks of the state it starts from and of the
    state after the first step, ``p0``, ``p1``, ``m1``, ``v1``, with
    that step's loss and gradient norm), then the launcher on one rank."""
    tmp = tmp_path_factory.mktemp("dp")
    ref = _reference_steps(tmp)
    _ranks(tmp, 4, f"""
        from repro_torch.configs import get_arch
        from repro_torch.distributed.sharding import ShardingCtx, default_rules
        from repro_torch.interop import train_state_from_jax
        from repro_torch.launch import train
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.models import get_model
        from repro_torch.training import TrainConfig, make_train_step
        cfg = get_arch({DP_ARCH!r}, reduced=True)
        model = get_model(cfg)
        mesh = make_host_mesh()
        assert mesh.shape == {DP_MESH!r}
        rules = dict(default_rules())
        rules.update(cfg.sharding_overrides or {{}})
        step = make_train_step(model, TrainConfig(**{TCFG!r}),
                               ShardingCtx(mesh=mesh, rules=rules))
        state = {{}}
        for key, v in np.load(os.path.join(out, "state.npz")).items():
            node = state
            *head, last = key.split("/")
            for h in head:
                node = node.setdefault(h, {{}})
            node[last] = v

        def flat(tree, prefix):   # copies: the step updates in place
            out = {{}}
            for k, v in tree.items():
                if isinstance(v, dict):
                    out.update(flat(v, prefix + "/" + k))
                else:
                    out[prefix + "/" + k] = v.detach().numpy().copy()
            return out

        state = train_state_from_jax(state, cfg, device="cpu")
        blocks = flat(state["params"], "p0")
        make = train.make_batch_fn(cfg, 8, 16)
        losses, norms = [], []
        for i in range(2):
            state, m = step(state, {{k: torch.from_numpy(v)
                                     for k, v in make(i).items()}})
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            if i == 0:
                for leaf, key in (("params", "p1"), ("m", "m1"), ("v", "v1")):
                    blocks.update(flat(state[leaf], key))
        np.savez(os.path.join(out, f"dp_{{rank}}.npz"), loss=losses[0],
                 gnorm=norms[0], **blocks)
        run = train.run({DP_ARCH!r}, reduced=True, device="cpu",
                        log_every=100, **{TRAIN_KW!r})
        with open(os.path.join(out, f"dp_{{rank}}.json"), "w") as f:
            json.dump([losses, norms, run["losses"], run["grad_norms"]], f)
    """, timeout=300)
    got = [json.load(open(tmp / f"dp_{r}.json")) for r in range(4)]
    from repro_torch.launch import train
    one = train.run(DP_ARCH, reduced=True, device="cpu", log_every=100,
                    **TRAIN_KW)
    return tmp, ref, got, one


def test_data_parallel_step_on_4_ranks_matches_the_reference(dp_runs):
    """The port's 4-rank step against the reference's one-device step on
    the same global batch, which is what the reference's sharded step
    computes; the launcher on 4 ranks against its one-rank run."""
    _, ref, got, one = dp_runs
    assert all(g == got[0] for g in got), got   # every rank steps alike
    losses, norms, run_losses, run_norms = got[0]
    np.testing.assert_allclose(losses, ref["one"][0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(norms, ref["one"][1], rtol=NORM_RTOL)
    # the launcher on 4 ranks against its one-rank run of the same batches
    np.testing.assert_allclose(run_losses, one["losses"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(run_norms, one["grad_norms"], rtol=NORM_RTOL)


@pytest.mark.parametrize("what", ["metrics", "first_step_state",
                                  "initial_shards"])
def test_data_parallel_step_on_4_ranks_matches_the_mesh_program(dp_runs,
                                                                what):
    """The port's 4-rank steps against the reference's jitted step on an
    ``Auto`` (4, 1) mesh: both steps' losses and gradient norms; the
    state after the first step and the state it starts from, each rank's
    blocks against the device's at its mesh coordinates, with the checks
    of ``tests/test_torch_tensor_parallel.py``."""
    from test_torch_tensor_parallel import (check_mesh_shards,
                                            check_mesh_train_step)
    tmp, ref, got, _ = dp_runs
    if what == "metrics":
        for g in got:
            np.testing.assert_allclose(g[0], ref["mesh"][0], rtol=LOSS_RTOL)
            np.testing.assert_allclose(g[1], ref["mesh"][1], rtol=NORM_RTOL)
    elif what == "first_step_state":
        check_mesh_train_step(tmp, tmp, DP_ARCH, DP_MESH, stem="dp")
    else:
        check_mesh_shards(tmp, tmp, DP_ARCH, DP_MESH, stem="dp",
                          prefixes=("p0",))


# -------------------------------------------------------------- serving
def test_model_serve_on_2_ranks_generates_the_one_rank_tokens(tmp_path):
    kw = dict(reduced=True, requests=4, prompt_len=8, gen=4, device="cpu")
    _ranks(tmp_path, 2, f"""
        from repro_torch.launch import model_serve
        r = model_serve.run("qwen3-0.6b", **{kw!r})
        np.save(os.path.join(out, f"gen_{{rank}}.npy"), r["generated"])
    """)
    from repro_torch.launch import model_serve
    want = model_serve.run("qwen3-0.6b", **kw)["generated"]
    for r in range(2):
        np.testing.assert_array_equal(np.load(tmp_path / f"gen_{r}.npy"), want)
