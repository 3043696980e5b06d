"""The same seed gives the same traffic, faces and weights; another
seed other ones, with every query the same size."""
import itertools

import torch

import _paths  # noqa: F401
import reference
from harness import cell, collection, spec, weights
from harness.seeds import stream

SEED = 2**33 + 12345


def _queries(seed, tag="window", n=6):
    mix = spec.traffic("preprocess")
    streams = cell.client_streams(mix, 413, seed, "udf", "lfw", tag)
    return [list(itertools.islice(s, n)) for s in streams]


def test_same_seed_same_traffic():
    assert _queries(SEED) == _queries(SEED)
    assert _queries(SEED) != _queries(SEED + 1)
    assert _queries(SEED) != _queries(SEED, "warmup")


def test_every_query_asks_for_the_same_number_of_distinct_groups():
    mix = spec.traffic("preprocess")
    for client in _queries(SEED, n=20):
        for query, meta in client:
            groups = meta["groups"]
            assert len(set(groups)) == mix["groups_per_query"]
            assert all(0 <= g < 413 for g in groups)
            cons = query[0]["FindImage"]["constraints"]["group"]
            assert cons == ["in", groups]


def test_streams_are_independent_and_take_large_seeds():
    assert stream(SEED, "faces/0") != stream(SEED, "faces/1")
    assert stream(SEED, "weights") == stream(SEED, "weights")
    assert 0 <= stream(2**40, "weights") < 2**63


def test_faces_repeat_for_a_seed():
    a = collection.faces(3, 32, SEED, "cpu")
    b = collection.faces(3, 32, SEED, "cpu")
    c = collection.faces(3, 32, SEED + 1, "cpu")
    assert a.shape == (3, 32, 32, 3) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0


def test_weights_repeat_for_a_seed_and_follow_the_layout():
    cfg = {"d_model": 8, "num_layers": 1, "d_ff": 16, "rwkv_mix_lora": 2,
           "rwkv_decay_lora": 3, "rwkv_head_dim": 4, "vocab_size": 10,
           "vocab_pad_multiple": 8}
    layout = reference.model("rwkv6").layout(cfg)
    a = weights.make(layout, SEED, "cpu")
    b = weights.make(layout, SEED, "cpu")
    assert a["embed"].shape == (16, 8)
    assert torch.equal(a["blocks"]["w_r"], b["blocks"]["w_r"])
    assert not torch.equal(weights.make(layout, SEED + 1, "cpu")["embed"],
                           a["embed"])
    assert float(a["blocks"]["decay_base"].unique()) == -4.0
    assert float(a["embed"].abs().max()) <= 3 * 0.02 + 1e-7
