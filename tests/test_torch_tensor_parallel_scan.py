"""Tensor parallelism of the scan families across CPU ``gloo`` ranks,
and the (2, 2) mesh, held against the JAX package's one-device programs
and its programs on the same mesh (``Auto`` axes: the reference fails
only on ``Explicit`` ones), shard by shard, with the checks of
``tests/test_torch_tensor_parallel.py``.  The launchers keep their
one-rank yardstick: the reference's build ``Explicit`` meshes.

- Reduced zamba2-2.7b (Mamba2: the fused ``in_proj`` split off its heads
  and regrouped, K4's plain version on each rank's heads; the shared
  attention on its heads) and rwkv6-1.6b (the WKV scan on each rank's
  heads, ``c_r`` gathered) at ``model_par=2`` on 2 ranks: forward logits,
  greedy tokens at an even and an odd slot count, one train step (loss,
  gradient norm, moments, replicated leaves equal across ranks), and
  the local shards of the parameters and the prefill cache.  zamba2 also
  with its ``sharding_overrides`` (``cache_heads`` on ``model``): the
  cache split by heads, the tokens the reference's.
- Reduced qwen3-0.6b and zamba2-2.7b on 4 ranks as a (2, 2) mesh: the
  same checks, each data index on its rows; and both launchers at
  ``model_par=2`` there against their one-rank runs.
- A model axis of 4 ranks, (1, 4): reduced qwen3-0.6b, whose 2 kv
  heads split into quarter heads (gathered before the attention), and
  qwen3 with 6 query heads over 2 kv heads, which do not divide the
  axis (the attention runs whole on each rank, ``wo`` row-parallel).
- A tensor-parallel train state checkpointed by ``TrainSupervisor``:
  the file holds the full leaves, and a resume gives each rank its
  shards back; ``remesh_tree`` takes the state from the (1, 2) mesh to
  a (2, 1) mesh, each rank's shard the slice of the full leaf.
"""
import numpy as np
import pytest

from test_torch_tensor_parallel import (_spec_slice, _specs,
                                        check_forward, check_greedy,
                                        check_mesh_forward, check_mesh_greedy,
                                        check_mesh_shards,
                                        check_mesh_train_step, check_shards,
                                        check_train_step, reference_outputs,
                                        run_families)

SCAN = ["zamba2-2.7b", "rwkv6-1.6b"]
MESH4 = ["qwen3-0.6b", "zamba2-2.7b"]
# a model axis of 4: qwen3's 2 kv heads of 16 split into 8-column
# quarters (gathered, each rank's query head reads its one kv head), and
# 6 query heads over 2 kv heads, which do not divide 4 (the attention
# runs whole on every rank, ``wo`` on each rank's rows)
MODEL4 = ["qwen3-0.6b", "qwen3-0.6b+h6k2"]


@pytest.fixture(scope="module")
def ref_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_scan_ref")
    meshes = ([(f, (1, 2), "body") for f in SCAN]
              + [("zamba2-2.7b", (1, 2), "over")]
              + [(f, (2, 2), "body") for f in MESH4]
              + [(f, (1, 4), "body") for f in MODEL4])
    reference_outputs(d, ["zamba2-2.7b", "rwkv6-1.6b", "qwen3-0.6b",
                          "qwen3-0.6b+h6k2"], meshes=meshes)
    return d


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, ref_dir):
    tmp = tmp_path_factory.mktemp("tp_scan_ranks")
    run_families(tmp, ref_dir, SCAN, 2, (1, 2), extra="""
        # zamba2 under its sharding_overrides: the cache split by heads
        from repro_torch.distributed.fault import TrainSupervisor
        from repro_torch.distributed.elastic import remesh_tree
        from repro_torch.models.lm import tree_map
        from repro_torch.training.train_step import train_state_axes
        cfg = config("zamba2-2.7b", get_arch)
        api = get_model(cfg)
        ref = np.load(os.path.join(REF, "zamba2-2.7b.npz"))
        rules = dict(default_rules(), **cfg.sharding_overrides)
        osh = ShardingCtx(mesh=mesh, rules=rules)
        params = params_from_jax(unflat(ref, "params"), cfg, "cpu", mesh)
        b = {k: torch.from_numpy(v) for k, v in unflat(ref, "b").items()}
        res = {}
        with torch.no_grad():
            toks = greedy_generate(api, params, b, steps=STEPS, sh=osh,
                                   max_cache=slots(cfg)[0])
            _, cache = api.prefill(params, b, osh, slots(cfg)[0])
        assert cache["k"].shape[3] == cfg.num_kv_heads // 2
        res["tok_over"] = toks.numpy()
        res.update(flat(dict(cache), "cache"))
        np.savez(os.path.join(out, f"over_{rank}.npz"), **res)

        # a checkpoint of the sharded train state, and its resume
        state = train_state_from_jax(unflat(ref, "s"), cfg, "cpu", mesh, rules)
        layout = Layout(osh, unflat(ref, "s"), train_state_axes(api))
        sup = TrainSupervisor(os.path.join(out, "ckpt"), save_every=1,
                              layout=layout)
        sup.maybe_save(1, state)
        dist.barrier()
        back, start = sup.resume(state)
        assert start == 1
        for a, c in zip(flat(state, "s").values(), flat(back, "s").values()):
            assert np.array_equal(a, c)

        # remesh the sharded state from (1, 2) to (2, 1)
        mesh21 = make_host_mesh(model=1)
        moved = remesh_tree(layout.dtensors(state), train_state_axes(api),
                            mesh21, rules)
        np.savez(os.path.join(out, f"remesh_{rank}.npz"),
                 **flat(tree_map(lambda t: t.to_local(), moved), "s"))
    """)
    return tmp


LAUNCH = dict(arch="qwen3-0.6b", serve=dict(requests=4, prompt_len=8,
                                             gen=4),
              train=dict(steps=2, batch=4, seq=16))


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory, ref_dir):
    tmp = tmp_path_factory.mktemp("tp_mesh22_ranks")
    run_families(tmp, ref_dir, MESH4, 4, (2, 2), extra=f"""
        # both launchers at model_par=2 on the 4 ranks: a (2, 2) mesh
        from repro_torch.launch import model_serve, train
        r = model_serve.run({LAUNCH["arch"]!r}, reduced=True, model_par=2,
                            device="cpu", **{LAUNCH["serve"]!r})
        t = train.run({LAUNCH["arch"]!r}, reduced=True, model_par=2,
                      device="cpu", log_every=100, **{LAUNCH["train"]!r})
        np.savez(os.path.join(out, f"launch_{{rank}}.npz"),
                 gen=r["generated"], logits=r["logits"],
                 losses=np.array(t["losses"]), norms=np.array(t["grad_norms"]))
    """)
    return tmp


@pytest.fixture(scope="module")
def model4_ranks(tmp_path_factory, ref_dir):
    tmp = tmp_path_factory.mktemp("tp_model4_ranks")
    run_families(tmp, ref_dir, MODEL4, 4, (1, 4))
    return tmp


@pytest.mark.parametrize("name", SCAN)
def test_tp_scan_forward_logits_match_the_reference(ref_dir, two_ranks, name):
    check_forward(ref_dir, two_ranks, name, 2)


@pytest.mark.parametrize("tag", ["even", "odd"])
@pytest.mark.parametrize("name", SCAN)
def test_tp_scan_greedy_tokens_match_the_reference(ref_dir, two_ranks, name,
                                                   tag):
    check_greedy(ref_dir, two_ranks, name, 2, tag)


@pytest.mark.parametrize("name", SCAN)
def test_tp_scan_train_step_matches_the_reference(ref_dir, two_ranks, name):
    check_train_step(ref_dir, two_ranks, name, 2, (1, 2))


@pytest.mark.parametrize("name", SCAN)
def test_tp_scan_local_shards_are_their_spec_slices(ref_dir, two_ranks,
                                                    name):
    check_shards(ref_dir, two_ranks, name, 2, (1, 2))


@pytest.mark.parametrize("name", SCAN)
def test_tp_scan_forward_logits_match_the_mesh_program(ref_dir, two_ranks,
                                                       name):
    check_mesh_forward(ref_dir, two_ranks, name, (1, 2))


@pytest.mark.parametrize("tag", ["even", "odd"])
@pytest.mark.parametrize("name", SCAN)
def test_tp_scan_greedy_tokens_match_the_mesh_program(ref_dir, two_ranks,
                                                      name, tag):
    check_mesh_greedy(ref_dir, two_ranks, name, (1, 2), tag)


@pytest.mark.parametrize("name", SCAN)
def test_tp_scan_train_step_matches_the_mesh_program(ref_dir, two_ranks,
                                                     name):
    check_mesh_train_step(ref_dir, two_ranks, name, (1, 2))


@pytest.mark.parametrize("name", SCAN)
def test_tp_scan_local_shards_are_the_mesh_programs_shards(ref_dir,
                                                           two_ranks, name):
    check_mesh_shards(ref_dir, two_ranks, name, (1, 2))


def test_zamba2_cache_split_by_heads_under_its_overrides(ref_dir, two_ranks):
    ref = np.load(ref_dir / "zamba2-2.7b.npz")
    specs = _specs("zamba2-2.7b", "cache", (1, 2), "train")
    assert any("model" in spec for _, spec in specs.values())
    for r in range(2):
        got = np.load(two_ranks / f"over_{r}.npz")
        np.testing.assert_array_equal(got["tok_over"], ref["tokens"])
        for path, (_, spec) in specs.items():
            want = _spec_slice(ref[path], spec, {"data": 0, "model": r},
                               {"data": 1, "model": 2})
            np.testing.assert_allclose(got[path], want, atol=1e-4, rtol=0,
                                       err_msg=path)


@pytest.mark.parametrize("what", ["tokens", "cache"])
def test_zamba2_cache_split_by_heads_matches_the_mesh_program(ref_dir,
                                                              two_ranks,
                                                              what):
    """Under its ``sharding_overrides`` (``cache_heads`` on ``model``):
    the greedy tokens and each rank's prefill cache against the mesh
    program run under the same rules."""
    if what == "tokens":
        check_mesh_greedy(ref_dir, two_ranks, "zamba2-2.7b", (1, 2), "over",
                          kind="over", stem="over")
    else:
        check_mesh_shards(ref_dir, two_ranks, "zamba2-2.7b", (1, 2),
                          kind="over", stem="over", prefixes=("cache",))


def test_tp_checkpoint_holds_full_leaves_and_remesh_to_2x1(ref_dir,
                                                           two_ranks):
    import json
    ref = np.load(ref_dir / "zamba2-2.7b.npz")
    step_dir = two_ranks / "ckpt" / "step_00000001"
    manifest = json.load(open(step_dir / "manifest.json"))
    with np.load(step_dir / "shard_0.npz") as data:
        for key in ("params/mamba/mixer/in_proj", "params/embed",
                    "m/shared/attn/wq"):
            want = ref["s/" + key]
            assert manifest["leaves"][key]["shape"] == list(want.shape)
            np.testing.assert_array_equal(data[key.replace("/", "__")], want)
    # the (2, 1) mesh splits by data what the (1, 2) mesh split by model
    from repro_torch.configs import get_arch
    from repro_torch.distributed.sharding import (Mesh, default_rules,
                                                  tree_to_specs)
    from repro_torch.models import get_model
    from repro_torch.models.registry import param_shapes
    from repro_torch.training.train_step import train_state_axes
    import torch
    cfg = get_arch("zamba2-2.7b", reduced=True)
    api = get_model(cfg)
    shapes = param_shapes(api)
    state = {"params": shapes, "m": shapes, "v": shapes,
             "step": torch.zeros((), device="meta")}
    rules = dict(default_rules(), **cfg.sharding_overrides)
    flat_specs = {}

    def walk(p, node):
        if isinstance(node, dict):
            for k, v in sorted(node.items()):
                walk(p + "/" + k, v)
        else:
            flat_specs[p] = node
    walk("s", tree_to_specs(state, train_state_axes(api),
                            Mesh(("data", "model"), (2, 1)), rules))
    source = _specs("zamba2-2.7b", "params", (1, 2), "train")
    assert any("model" in spec for _, spec in source.values())
    for r in range(2):
        got = np.load(two_ranks / f"remesh_{r}.npz")
        assert set(got.files) == set(flat_specs)
        for key, spec in flat_specs.items():
            want = _spec_slice(ref[key], spec, {"data": r, "model": 0},
                               {"data": 2, "model": 1})
            np.testing.assert_array_equal(got[key], want, err_msg=key)


@pytest.mark.parametrize("name", MESH4)
def test_mesh_2x2_forward_logits_match_the_reference(ref_dir, four_ranks,
                                                     name):
    check_forward(ref_dir, four_ranks, name, 4)


@pytest.mark.parametrize("tag", ["even", "odd"])
@pytest.mark.parametrize("name", MESH4)
def test_mesh_2x2_greedy_tokens_match_the_reference(ref_dir, four_ranks,
                                                    name, tag):
    check_greedy(ref_dir, four_ranks, name, 4, tag)


@pytest.mark.parametrize("name", MESH4)
def test_mesh_2x2_train_step_matches_the_reference(ref_dir, four_ranks,
                                                   name):
    check_train_step(ref_dir, four_ranks, name, 4, (2, 2))


@pytest.mark.parametrize("name", MESH4)
def test_mesh_2x2_local_shards_are_their_spec_slices(ref_dir, four_ranks,
                                                     name):
    check_shards(ref_dir, four_ranks, name, 4, (2, 2))


@pytest.mark.parametrize("name", MESH4)
def test_mesh_2x2_forward_logits_match_the_mesh_program(ref_dir, four_ranks,
                                                        name):
    check_mesh_forward(ref_dir, four_ranks, name, (2, 2))


@pytest.mark.parametrize("tag", ["even", "odd"])
@pytest.mark.parametrize("name", MESH4)
def test_mesh_2x2_greedy_tokens_match_the_mesh_program(ref_dir, four_ranks,
                                                       name, tag):
    check_mesh_greedy(ref_dir, four_ranks, name, (2, 2), tag)


@pytest.mark.parametrize("name", MESH4)
def test_mesh_2x2_train_step_matches_the_mesh_program(ref_dir, four_ranks,
                                                      name):
    check_mesh_train_step(ref_dir, four_ranks, name, (2, 2))


@pytest.mark.parametrize("name", MESH4)
def test_mesh_2x2_local_shards_are_the_mesh_programs_shards(ref_dir,
                                                            four_ranks, name):
    check_mesh_shards(ref_dir, four_ranks, name, (2, 2))


@pytest.mark.parametrize("name", MODEL4)
def test_model_axis_4_forward_logits_match_the_reference(ref_dir,
                                                         model4_ranks, name):
    check_forward(ref_dir, model4_ranks, name, 4)


@pytest.mark.parametrize("tag", ["even", "odd"])
@pytest.mark.parametrize("name", MODEL4)
def test_model_axis_4_greedy_tokens_match_the_reference(ref_dir, model4_ranks,
                                                        name, tag):
    check_greedy(ref_dir, model4_ranks, name, 4, tag)


@pytest.mark.parametrize("name", MODEL4)
def test_model_axis_4_train_step_matches_the_reference(ref_dir, model4_ranks,
                                                       name):
    check_train_step(ref_dir, model4_ranks, name, 4, (1, 4))


@pytest.mark.parametrize("name", MODEL4)
def test_model_axis_4_local_shards_are_their_spec_slices(ref_dir,
                                                         model4_ranks, name):
    check_shards(ref_dir, model4_ranks, name, 4, (1, 4))


@pytest.mark.parametrize("name", MODEL4)
def test_model_axis_4_forward_logits_match_the_mesh_program(ref_dir,
                                                            model4_ranks,
                                                            name):
    check_mesh_forward(ref_dir, model4_ranks, name, (1, 4))


@pytest.mark.parametrize("tag", ["even", "odd"])
@pytest.mark.parametrize("name", MODEL4)
def test_model_axis_4_greedy_tokens_match_the_mesh_program(ref_dir,
                                                           model4_ranks, name,
                                                           tag):
    check_mesh_greedy(ref_dir, model4_ranks, name, (1, 4), tag)


@pytest.mark.parametrize("name", MODEL4)
def test_model_axis_4_train_step_matches_the_mesh_program(ref_dir,
                                                          model4_ranks, name):
    check_mesh_train_step(ref_dir, model4_ranks, name, (1, 4))


@pytest.mark.parametrize("name", MODEL4)
def test_model_axis_4_local_shards_are_the_mesh_programs_shards(
        ref_dir, model4_ranks, name):
    check_mesh_shards(ref_dir, model4_ranks, name, (1, 4))


def test_launchers_at_model_par_2_on_4_ranks_match_one_rank(four_ranks):
    """``model_serve.run`` and ``launch.train.run`` at ``model_par=2`` on
    4 ranks (a (2, 2) mesh: data-parallel rows, tensor-parallel weights)
    against the same launchers on one rank: the greedy tokens equal,
    logits within 3e-4, losses within 1e-5 and gradient norms within
    1e-4, relative."""
    from repro_torch.launch import model_serve, train
    one = model_serve.run(LAUNCH["arch"], reduced=True, device="cpu",
                          **LAUNCH["serve"])
    steps = train.run(LAUNCH["arch"], reduced=True, device="cpu",
                      log_every=100, **LAUNCH["train"])
    for r in range(4):
        got = np.load(four_ranks / f"launch_{r}.npz")
        np.testing.assert_array_equal(got["gen"], one["generated"])
        np.testing.assert_allclose(got["logits"], one["logits"], atol=3e-4,
                                   rtol=0)
        np.testing.assert_allclose(got["losses"], steps["losses"], rtol=1e-5)
        np.testing.assert_allclose(got["norms"], steps["grad_norms"],
                                   rtol=1e-4)
