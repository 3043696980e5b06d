"""Tensor parallelism where a scan layer's heads do not split over the
model axis, on CPU ``gloo`` ranks, held against the JAX package's
one-device programs and its programs on the same mesh (``Auto`` axes;
the reference fails only on ``Explicit`` ones; 8 forced host devices),
shard by shard, with the checks (and tolerances) of
``tests/test_torch_tensor_parallel.py``.

The reference's rules replicate a dim that does not divide the mesh
axis (``safe_spec``), and GSPMD computes the rest; the port's Mamba2 and
RWKV6 layers then gather the leaves their specs split and compute every
head on every rank.

- Reduced zamba2-2.7b at ``model_par=3``: its 8 Mamba2 heads do not
  divide 3, nor does ``d_inner``, so the layer computes every head on
  every rank; its conv cache's 288 channels divide 3 and split as their
  spec names, 96 a rank, as on the reference's devices.
- Reduced rwkv6-1.6b at ``model_par=8``: its ``d_model`` of 64 splits
  over 8 (``w_r``, ``w_k``, ... hold 8 columns a rank), its 4 heads do
  not.
- Reduced whisper-small with 6 heads at ``model_par=4``: the heads do
  not divide 4, so the attention runs whole on every rank, the decode
  step's cross-attention too (the greedy tokens go through it).
"""
import pytest

from test_torch_tensor_parallel import (check_forward, check_greedy,
                                        check_mesh_forward, check_mesh_greedy,
                                        check_mesh_shards,
                                        check_mesh_train_step, check_shards,
                                        check_train_step, reference_outputs,
                                        run_families)

CASES = {"zamba2-2.7b": 3, "rwkv6-1.6b": 8, "whisper-small+h6k6": 4}


@pytest.fixture(scope="module")
def ref_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("uneven_ref")
    reference_outputs(d, list(CASES), devices=8,
                      meshes=[(f, (1, n), "body") for f, n in CASES.items()])
    return d


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, ref_dir):
    out = {}
    for name, n in CASES.items():
        tmp = tmp_path_factory.mktemp(f"uneven_{n}")
        run_families(tmp, ref_dir, [name], n, (1, n))
        out[name] = tmp
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_uneven_heads_forward_logits_match_the_reference(ref_dir, ranks,
                                                         name):
    check_forward(ref_dir, ranks[name], name, CASES[name])


@pytest.mark.parametrize("tag", ["even", "odd"])
@pytest.mark.parametrize("name", list(CASES))
def test_uneven_heads_greedy_tokens_match_the_reference(ref_dir, ranks, name,
                                                        tag):
    check_greedy(ref_dir, ranks[name], name, CASES[name], tag)


@pytest.mark.parametrize("name", list(CASES))
def test_uneven_heads_train_step_matches_the_reference(ref_dir, ranks, name):
    check_train_step(ref_dir, ranks[name], name, CASES[name],
                     (1, CASES[name]))


@pytest.mark.parametrize("name", list(CASES))
def test_uneven_heads_local_shards_are_their_spec_slices(ref_dir, ranks,
                                                         name):
    check_shards(ref_dir, ranks[name], name, CASES[name], (1, CASES[name]))


@pytest.mark.parametrize("name", list(CASES))
def test_uneven_heads_forward_logits_match_the_mesh_program(ref_dir, ranks,
                                                            name):
    check_mesh_forward(ref_dir, ranks[name], name, (1, CASES[name]))


@pytest.mark.parametrize("tag", ["even", "odd"])
@pytest.mark.parametrize("name", list(CASES))
def test_uneven_heads_greedy_tokens_match_the_mesh_program(ref_dir, ranks,
                                                           name, tag):
    check_mesh_greedy(ref_dir, ranks[name], name, (1, CASES[name]), tag)


@pytest.mark.parametrize("name", list(CASES))
def test_uneven_heads_train_step_matches_the_mesh_program(ref_dir, ranks,
                                                          name):
    check_mesh_train_step(ref_dir, ranks[name], name, (1, CASES[name]))


@pytest.mark.parametrize("name", list(CASES))
def test_uneven_heads_local_shards_are_the_mesh_programs_shards(ref_dir,
                                                                ranks, name):
    check_mesh_shards(ref_dir, ranks[name], name, (1, CASES[name]))
