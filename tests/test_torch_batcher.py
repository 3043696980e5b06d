"""``tests/test_batcher.py`` on the port, function by function under the
same names: the ``GroupBatcher`` must equal per-request greedy decoding
(reduced qwen3-0.6b from the reference's ``PRNGKey(0)`` tree through
``interop.params_from_jax``, the reference's tokens beside the port's),
group by prompt length, free a slot at EOS; and a tree re-sharded from
one mesh to another comes back whole.

The reference's remesh runs (2, 4) on 8 forced host devices → (1, 4) on
the first 4; the port's runs the same on 8 gloo ranks in subprocesses (a
``file://`` store under ``tmp_path``), ``launch.mesh.make_mesh`` giving
the 4 survivors their own mesh, with the same trees, axes and
assertions: the full tensors after the round trip equal the originals,
the 4 ranks left out hold nothing, and ``shrink_batch_for_mesh`` keeps
100 and cuts 7 to 6 on a mesh of 2 data ranks.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def setup():
    import jax
    from repro.configs import get_arch as ref_arch
    from repro.models import get_model as ref_model
    from repro_torch.configs import get_arch
    from repro_torch.interop import params_from_jax
    from repro_torch.models import get_model
    rcfg = ref_arch("qwen3-0.6b", reduced=True)
    rapi = ref_model(rcfg)
    tree = rapi.init(jax.random.PRNGKey(0))
    cfg = get_arch("qwen3-0.6b", reduced=True)
    api = get_model(cfg)
    return cfg, api, params_from_jax(tree, cfg, device="cpu"), rapi, tree


def _port_greedy(api, params, p, steps):
    from repro_torch.distributed.sharding import ShardingCtx
    from repro_torch.serving.serve_step import greedy_generate
    toks = torch.tensor(np.asarray(p)[None], dtype=torch.int32)
    return greedy_generate(api, params, {"tokens": toks}, steps=steps,
                           sh=ShardingCtx(mesh=None))[0].numpy()


def test_batched_equals_sequential(setup):
    import jax.numpy as jnp
    from repro.distributed.sharding import REPLICATED
    from repro.serving import greedy_generate as ref_greedy
    from repro_torch.serving.batcher import GroupBatcher
    cfg, api, params, rapi, tree = setup
    b = GroupBatcher(api, params, group_size=4, max_new_default=5)
    prompts = [np.arange(1, 9) + i for i in range(6)]
    reqs = [b.submit(p) for p in prompts]
    b.run_until_idle()
    for p, r in zip(prompts, reqs):
        got = r.result(timeout=5)
        np.testing.assert_array_equal(got, _port_greedy(api, params, p, 5))
        want = ref_greedy(
            rapi, tree, {"tokens": jnp.asarray(p)[None].astype(jnp.int32)},
            steps=5, sh=REPLICATED)
        np.testing.assert_array_equal(got, np.asarray(want)[0])
    assert b.groups_run == 2  # 6 requests / group_size 4


def test_mixed_prompt_lengths_grouped(setup):
    from repro_torch.serving.batcher import GroupBatcher
    cfg, api, params, _, _ = setup
    b = GroupBatcher(api, params, group_size=8, max_new_default=3)
    reqs = ([b.submit(np.arange(1, 7)) for _ in range(3)]
            + [b.submit(np.arange(1, 11)) for _ in range(3)])
    b.run_until_idle()
    for r in reqs:
        assert len(r.result(timeout=5)) == 3
    assert b.groups_run >= 2  # two length classes cannot share a group
    for r, p in zip(reqs, [np.arange(1, 7)] * 3 + [np.arange(1, 11)] * 3):
        np.testing.assert_array_equal(r.result(timeout=5),
                                      _port_greedy(api, params, p, 3))


def test_eos_frees_early(setup):
    from repro_torch.serving.batcher import GroupBatcher
    cfg, api, params, _, _ = setup
    b = GroupBatcher(api, params, group_size=2, max_new_default=8)
    # the first generated token, then used as eos
    probe = b.submit(np.arange(1, 9))
    b.run_until_idle()
    first = int(probe.result()[0])
    b2 = GroupBatcher(api, params, group_size=2, max_new_default=8)
    r = b2.submit(np.arange(1, 9), eos_id=first)
    b2.run_until_idle()
    assert len(r.result()) == 1  # stopped at EOS immediately


_REMESH = r"""
import os, sys
sys.path.insert(0, {src!r})
rank, store = int(sys.argv[1]), sys.argv[2]
import torch
import torch.distributed as dist
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=8)
try:
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed.elastic import (remesh_tree,
                                                 shrink_batch_for_mesh)
    from repro_torch.distributed.sharding import default_rules
    from repro_torch.launch.mesh import make_host_mesh, make_mesh
    tree = {{"w": torch.arange(64.0).reshape(8, 8), "b": torch.arange(8.0)}}
    axes = {{"w": ("embed", "ff"), "b": (None,)}}
    m8 = make_host_mesh(model=4)
    m4 = make_mesh((1, 4), ("data", "model"))
    assert m8.shape == (2, 4) and m4.shape == (1, 4)
    t8 = remesh_tree(tree, axes, m8, default_rules())
    t4 = remesh_tree(t8, axes, m4, default_rules())
    assert isinstance(t4["w"], DTensor)
    assert t4["w"].device_mesh is m4.device_mesh
    if rank < 4:
        assert t4["w"].to_local().shape == (8, 2)
        assert torch.equal(t4["w"].full_tensor(), tree["w"])
        assert torch.equal(t4["b"].full_tensor(), tree["b"])
    else:
        assert m4.device_mesh.get_coordinate() is None
        assert t4["w"].to_local().numel() == 0
    try:
        make_mesh((2, 8), ("data", "model"))
        raise AssertionError("a mesh of 16 ranks on a world of 8")
    except ValueError:
        pass
    assert shrink_batch_for_mesh(100, m8) == 100
    assert shrink_batch_for_mesh(7, m8) == 6
    dist.barrier()
    print("REMESH_OK")
finally:
    dist.destroy_process_group()
"""


def test_elastic_remesh_roundtrip(tmp_path):
    script = tmp_path / "remesh.py"
    script.write_text(_REMESH.format(src=os.path.join(ROOT, "src")))
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "PYTHONPATH")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(tmp_path / "store")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=ROOT) for r in range(8)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(outs)
    assert all("REMESH_OK" in o for o in outs), "\n".join(outs)
