"""The PyTorch port on a CUDA card: each hand-written kernel against its
plain version, and the engine's main path through the kernels.  Every
test here is marked ``cuda`` and skips on a host without a card; on a
card's host run ``python -m pytest -q -m cuda tests/test_torch_cuda.py``
(this file imports no JAX, so it needs only the port).

Tolerances (absolute, float32 images in [0, 1]): blur kernel 1e-5 (the
same taps in the same order, rounded separately), fused preprocess
kernel 1e-4 (band sums in another order than the composed products).
"""
import hashlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import preprocess as pp
from repro_torch.kernels import ref

STATIC_SHA256 = "778564da3d5f5530f0f4761d6af9f4c901796a91ff38620f2b75dd8cfa03a1b0"

PREPROCESS_CASES = [
    # (N, H, W), resize (h, w), crop (x, y, w, h), method
    ((2, 31, 29), (40, 36), (3, 5, 20, 24), "bilinear"),     # odd sizes
    ((1, 40, 48), (24, 20), (10, 12, 30, 30), "bilinear"),   # clamped crop
    ((2, 64, 50), (16, 12), (0, 0, 16, 12), "linear"),       # downsample
    ((1, 20, 20), (33, 27), (-4, 50, 8, 9), "cubic"),        # start clamps
    ((3, 250, 250), (256, 256), (16, 16, 224, 224), "bilinear"),
    ((1, 1080, 1920), (224, 224), (0, 0, 224, 224), "lanczos3"),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _uniform(seed, shape, device):
    x = np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)
    return torch.from_numpy(x).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,ksize,sigma", [
    ((3, 37, 45, 3), 5, 1.5), ((2, 70, 33, 1), 9, 2.0),
    ((1, 5, 4, 4), 31, 0.0), ((2, 224, 224, 3), 9, 2.0),
    ((1, 1080, 1920, 3), 5, 1.5), ((1, 9, 11, 3), 4, 1.0)])
def test_blur_kernel_matches_plain(cuda, shape, ksize, sigma):
    from repro_torch.kernels.gaussian_blur import gaussian_blur_cuda, launches
    x = _uniform(ksize, shape, cuda)
    before = launches.count
    got = gaussian_blur_cuda(x, ksize, sigma)
    want = ref.gaussian_blur_ref(x, ksize, sigma)
    torch.cuda.synchronize()
    assert launches.count == before + 1
    assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("shape,res,crop,method", PREPROCESS_CASES)
def test_preprocess_kernel_matches_plain(cuda, shape, res, crop, method):
    x = _uniform(sum(shape), shape + (3,), cuda)
    kw = dict(resize_h=res[0], resize_w=res[1], method=method,
              crop_x=crop[0], crop_y=crop[1], crop_w=crop[2],
              crop_h=crop[3], mean=0.45, std=0.22)
    before = pp.launches.count
    got = pp.fused_resize_crop_normalize_cuda(x, **kw)
    want = pp.fused_resize_crop_normalize_ref(x, **kw)
    torch.cuda.synchronize()
    assert pp.launches.count == before + 1
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_engine_static_hash_and_device_backend_on_the_card(cuda):
    from repro_torch.core.engine import VDMSAsyncEngine
    from repro_torch.kernels import gaussian_blur as gb
    eng = VDMSAsyncEngine(device="cuda", num_remote_servers=2)
    try:
        rng = np.random.default_rng(11)
        for i in range(8):
            img = rng.uniform(0, 1, (32, 32, 3)).astype(np.float32)
            eng.add_entity("image", img, {"category": "dsp", "idx": i})
        res = eng.execute([{"FindImage": {
            "constraints": {"category": ["==", "dsp"]}, "operations": [
                {"type": "crop", "x": 4, "y": 4, "width": 24, "height": 24},
                {"type": "remote", "url": "u", "options": {"id": "flip"}},
                {"type": "rotate", "k": 1},
                {"type": "threshold", "value": 0.5}]}}], timeout=120)
    finally:
        eng.shutdown()
    h = hashlib.sha256()
    for eid, arr in res["entities"].items():
        assert isinstance(arr, np.ndarray)
        arr = np.ascontiguousarray(arr)
        h.update(eid.encode())
        h.update(str(arr.shape).encode())
        h.update(str(arr.dtype).encode())
        h.update(arr.tobytes())
    assert h.hexdigest() == STATIC_SHA256

    pipe = [{"type": "resize", "width": 64, "height": 64},
            {"type": "crop", "x": 8, "y": 8, "width": 48, "height": 48},
            {"type": "normalize", "mean": 0.45, "std": 0.22},
            {"type": "blur", "ksize": 9, "sigma_x": 2.0}]
    pinned = {o["type"]: {"device": 1e-6, "native": 10.0, "remote": 10.0,
                          "batcher": 10.0} for o in pipe}
    query = [{"FindImage": {"constraints": {"category": ["==", "d"]},
                            "operations": pipe}}]
    out = {}
    for mode in ("native", "cost"):
        kw = (dict(device_backend=True, cost_overrides=pinned)
              if mode == "cost" else {})
        eng = VDMSAsyncEngine(device="cuda", dispatch=mode, **kw)
        try:
            for i in range(6):
                img = np.random.default_rng(i).uniform(
                    0, 1, (72, 72, 3)).astype(np.float32)
                eng.add_entity("image", img, {"category": "d"})
            k1, k2 = gb.launches.count, pp.launches.count
            out[mode] = eng.execute(query, timeout=120)["entities"]
            assert gb.launches.count > k1
            if mode == "cost":
                assert pp.launches.count > k2
                assert eng.dispatch_stats()["device"]["fused_segments"] > 0
        finally:
            eng.shutdown()
    for eid in out["native"]:
        np.testing.assert_allclose(out["cost"][eid], out["native"][eid],
                                   atol=1e-4, rtol=0)
