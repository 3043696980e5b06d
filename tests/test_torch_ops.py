"""Op layer of the PyTorch port held against the JAX package: all 13
native ops and the four face UDFs of ``repro.visual``, on the same numpy
images, plus batched (B, H, W, C) application against per-image
application.

Tolerances (absolute, float32 images in [0, 1]):
- threshold, flip, rotate, crop, caption: bit-exact (no arithmetic, or
  arithmetic that is exact);
- resize, upsample, downsample: 1e-5 (two matrix products summed in
  another order than XLA's);
- every other op: 1e-6;
- ``detect_face``: the chosen (cx, cy, r) exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dataio.synthetic import synthetic_faces
from repro.visual import facedetect as jfd
from repro.visual import ops as jops
from repro_torch.visual import facedetect as tfd
from repro_torch.visual import ops as tops

torch.set_num_threads(1)

EXACT = {"threshold", "flip", "rotate", "crop", "caption"}
RESIZE_TOL = 1e-5
TOL = 1e-6

OP_CASES = [
    ("crop", dict(x=4, y=6, width=20, height=16)),
    ("crop", dict(x=30, y=25, width=20, height=16)),      # start clamps
    ("crop", dict(x=-3, y=2, width=64, height=10)),       # window shrinks
    ("resize", dict(width=23, height=17)),
    ("resize", dict(width=12, height=9)),                 # antialiased
    ("resize", dict(width=50, height=31, method="cubic")),
    ("resize", dict(width=19, height=44, method="lanczos3")),
    ("resize", dict(width=15, height=60, method="nearest")),
    ("rotate", dict(k=1)),
    ("rotate", dict(k=2)),
    ("rotate", dict(k=-1)),
    ("flip", dict(axis="horizontal")),
    ("flip", dict(axis="vertical")),
    ("grayscale", {}),
    ("blur", dict(ksize=5, sigma_x=1.5)),
    ("blur", dict(ksize=3, sigma_x=0.0, sigma_y=2.0)),
    ("threshold", dict(value=0.5)),
    ("threshold", dict(value=0.3, max_value=0.8)),
    ("normalize", dict(mean=0.45, std=0.22)),
    ("upsample", dict(fx=1.5, fy=2.0)),
    ("downsample", dict(fx=2.0, fy=3.0)),
    ("caption", dict(text="LFW 9:", x=2, y=2)),
    ("caption", dict(text="EDGE", x=30, y=35, intensity=0.5)),
    ("box", dict(x=5, y=4, width=20, height=15, thickness=3)),
    ("circle_mask", dict(cx=14, cy=20, r=9)),
    ("circle_mask", dict(cx=3, cy=30, r=12, keep_inside=False)),
]


def _images():
    faces = synthetic_faces(2, 40, seed=3)
    odd = np.random.default_rng(5).uniform(0, 1, (37, 29, 3)).astype(np.float32)
    return [faces[0], faces[1], odd]


def _tol(name):
    return RESIZE_TOL if name in ("resize", "upsample", "downsample") else TOL


def test_every_native_op_is_covered():
    assert set(tops.NATIVE_OPS) == set(jops.NATIVE_OPS)
    assert {name for name, _ in OP_CASES} == set(jops.NATIVE_OPS)


@pytest.mark.parametrize("name,params", OP_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(OP_CASES)])
def test_op_matches_jax(name, params):
    for img in _images():
        want = np.asarray(jops.apply_native_op(name, jnp.asarray(img), params))
        got = tops.apply_native_op(name, torch.from_numpy(img), params).numpy()
        assert got.shape == want.shape and got.dtype == want.dtype
        if name in EXACT:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, atol=_tol(name), rtol=0)


@pytest.mark.parametrize("name,params", OP_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(OP_CASES)])
def test_batched_op_matches_per_image(name, params):
    batch = torch.from_numpy(synthetic_faces(3, 40, seed=7))
    got = tops.apply_native_op(name, batch, params)
    for i in range(batch.shape[0]):
        one = tops.apply_native_op(name, batch[i], params)
        np.testing.assert_allclose(got[i].numpy(), one.numpy(),
                                   atol=_tol(name), rtol=0)


# ------------------------------------------------------------ face UDFs
UDFS = [("facedetect_box", {}), ("facedetect_mask", {"r": 12}),
        ("manipulation", {}), ("activityrecognition", {})]
_JUDF = {"facedetect_box": jfd.facedetect_box,
         "facedetect_mask": jfd.facedetect_mask,
         "manipulation": jfd.facedetect_manipulation,
         "activityrecognition": jfd.activity_recognition}
_TUDF = {"facedetect_box": tfd.facedetect_box,
         "facedetect_mask": tfd.facedetect_mask,
         "manipulation": tfd.facedetect_manipulation,
         "activityrecognition": tfd.activity_recognition}


@pytest.mark.parametrize("size", [48, 96, 250])
def test_detect_face_picks_the_same_cell(size):
    faces = synthetic_faces(4, size, seed=size)
    for img in faces:
        want = [int(v) for v in jfd.detect_face(jnp.asarray(img))]
        got = [int(v) for v in tfd.detect_face(torch.from_numpy(img))]
        assert got == want
    batched = tfd.detect_face(torch.from_numpy(faces))
    per = [tfd.detect_face(torch.from_numpy(img)) for img in faces]
    for k in range(3):
        assert batched[k].tolist() == [int(p[k]) for p in per]


@pytest.mark.parametrize("name,params", UDFS)
def test_face_udf_matches_jax(name, params):
    faces = synthetic_faces(3, 64, seed=11)
    for img in faces:
        want = np.asarray(_JUDF[name](jnp.asarray(img), **params))
        got = _TUDF[name](torch.from_numpy(img), **params).numpy()
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    batched = _TUDF[name](torch.from_numpy(faces), **params).numpy()
    for i, img in enumerate(faces):
        one = _TUDF[name](torch.from_numpy(img), **params).numpy()
        np.testing.assert_array_equal(batched[i], one)


def test_ops_do_not_write_into_their_input():
    img = torch.from_numpy(synthetic_faces(1, 40, seed=1)[0])
    before = img.clone()
    for name, params in OP_CASES:
        tops.apply_native_op(name, img, params)
    for name, params in UDFS:
        _TUDF[name](img, **params)
    assert torch.equal(img, before)
