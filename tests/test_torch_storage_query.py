"""The port's blob store, query language and data pipeline held against
``tests/test_storage_query.py``: the LRU store with disk spill, query
parsing and validation, and the seeded token stream, synthetic faces
and prefetching loader.  Parsed commands and the seeded data equal the
reference's exactly."""
import numpy as np
import pytest

from repro.dataio import lm_token_stream as ref_lm_token_stream
from repro.dataio import synthetic_faces as ref_synthetic_faces
from repro.query.language import parse_query as ref_parse_query
from repro_torch.dataio import ShardedLoader, lm_token_stream, synthetic_faces
from repro_torch.query.language import parse_query
from repro_torch.storage.store import BlobStore


def test_blobstore_roundtrip():
    s = BlobStore()
    a = np.random.default_rng(0).uniform(size=(8, 8, 3)).astype(np.float32)
    s.put("x", a)
    np.testing.assert_array_equal(s.get("x"), a)
    assert "x" in s
    s.delete("x")
    assert "x" not in s
    with pytest.raises(KeyError):
        s.get("x")


def test_blobstore_spills_to_disk_and_reloads(tmp_path):
    s = BlobStore(capacity_bytes=4096, spill_dir=str(tmp_path))
    arrs = {f"k{i}": np.full((16, 16), i, np.float32) for i in range(8)}
    for k, a in arrs.items():
        s.put(k, a)
    assert s.spills > 0
    for k, a in arrs.items():  # everything still retrievable
        np.testing.assert_array_equal(s.get(k), a)


QUERY = [{"FindImage": {
    "constraints": {"a": ["==", 1]},
    "operations": [{"type": "resize", "width": 4, "height": 4},
                   {"type": "remote", "url": "u",
                    "options": {"id": "blur", "ksize": 3}},
                   {"type": "udf", "port": 1, "options": {"id": "f"}}]}}]


def _fields(cmds):
    return [(c.verb, c.kind, c.constraints,
             [(o.name, o.params, o.where, o.url, o.port)
              for o in c.operations]) for c in cmds]


def test_parse_query_validates():
    cmds = parse_query(QUERY)
    assert cmds[0].verb == "find" and cmds[0].kind == "image"
    ops = cmds[0].operations
    assert [o.where for o in ops] == ["native", "remote", "udf"]
    assert ops[1].kwargs == {"ksize": 3}
    with pytest.raises(ValueError):
        parse_query([{"Nope": {}}])
    with pytest.raises(ValueError):
        parse_query([{"FindImage": {}, "FindVideo": {}}])
    # the same commands as the reference's parser
    assert _fields(cmds) == _fields(ref_parse_query(QUERY))


def test_lm_token_stream_deterministic_and_in_range():
    a = lm_token_stream(4, 32, 1000, step=7)
    b = lm_token_stream(4, 32, 1000, step=7)
    np.testing.assert_array_equal(a, b)
    c = lm_token_stream(4, 32, 1000, step=8)
    assert not np.array_equal(a, c)
    assert a.min() >= 0 and a.max() < 1000
    np.testing.assert_array_equal(a, ref_lm_token_stream(4, 32, 1000, step=7))


def test_synthetic_faces_deterministic():
    a = synthetic_faces(2, size=32, seed=5)
    b = synthetic_faces(2, size=32, seed=5)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (2, 32, 32, 3)
    assert 0 <= a.min() and a.max() <= 1
    np.testing.assert_array_equal(a, ref_synthetic_faces(2, size=32, seed=5))


def test_sharded_loader_prefetch_order():
    seen = []

    def make(step):
        seen.append(step)
        return {"x": np.full((2,), step, np.int32)}

    loader = ShardedLoader(make, prefetch=2, start_step=3)
    out = [next(loader) for _ in range(4)]
    loader.stop()
    assert [s for s, _ in out] == [3, 4, 5, 6]
    for s, b in out:
        assert b["x"][0] == s
