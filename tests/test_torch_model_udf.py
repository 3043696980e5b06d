"""The model UDF end to end on the CPU: a port engine running
``register_model_udf(arch=..., reduced=True, device="cpu")`` on the JAX
package's weights answers the JAX engine's stamped images, for the
hybrid ``zamba2-2.7b`` and the rwkv ``rwkv6-1.6b``.

The JAX engine's ``register_model_udf`` initialises its LM from
``PRNGKey(0)``; the same tree, carried by ``params_from_jax``, serves the
port's UDF.  Both engines hold the same four images (the port ingests
the JAX engine's state).  Greedy decoding makes every route stamp the
same label, so the images must be equal exactly, and the prompt tokens
of ``feats_of`` must be JAX's to the integer.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.core.engine import VDMSAsyncEngine as JaxEngine
from repro.core.udf import register_model_udf as jax_register_model_udf
from repro.models import get_model as jax_model
from repro_torch.configs import get_arch
from repro_torch.core.engine import VDMSAsyncEngine
from repro_torch.core.udf import prompt_tokens, register_model_udf
from repro_torch.interop import (engine_state, ingest_reference_state,
                                 params_from_jax)

torch.set_num_threads(1)

ARCH = "zamba2-2.7b"
RWKV_ARCH = "rwkv6-1.6b"
ROUTES = ("batcher", "device_backend", "per_entity")


def _udf(arch):
    return f"torch_parity_{arch}"


def _query(arch):
    return [{"FindImage": {"constraints": {"category": ["==", "lm"]},
                           "operations": [{"type": "udf",
                                           "options": {"id": _udf(arch)}}]}}]


def _route(arch, route):
    udf = _udf(arch)
    return {
        "per_entity": dict(dispatch="native"),
        "batcher": dict(dispatch="cost", cost_overrides={
            udf: {"batcher": 1e-6, "native": 10.0, "remote": 10.0}}),
        "device_backend": dict(dispatch="cost", device_backend="cpu",
                               cost_overrides={udf: {"device": 1e-6,
                                                     "native": 10.0,
                                                     "remote": 10.0,
                                                     "batcher": 10.0}}),
    }[route]


def _images(n):
    rng = np.random.default_rng(21)
    # sizes whose float32 pixel sums stay exact, and one odd shape
    shapes = [(24, 24, 3), (32, 40, 3), (17, 23, 3), (48, 48, 3)]
    return [rng.uniform(0, 1, shapes[i % len(shapes)]).astype(np.float32)
            for i in range(n)]


def _answer(arch):
    """The arch, the JAX engine's response and its state; the port's UDF
    registered on the JAX model's weights."""
    jax_register_model_udf(_udf(arch), arch=arch, reduced=True)
    jparams = jax_model(jax_arch(arch, reduced=True)).init(
        jax.random.PRNGKey(0))
    eng = JaxEngine(dispatch="native", num_native_workers=2)
    try:
        for i, img in enumerate(_images(4)):
            eng.add_entity("image", img, {"category": "lm", "idx": i})
        res = eng.execute(_query(arch), timeout=600)
        state = list(engine_state(eng))
    finally:
        eng.shutdown()
    assert res["stats"]["failed"] == 0
    params = params_from_jax(jax.tree.map(np.asarray, jparams),
                             get_arch(arch, reduced=True), device="cpu")
    register_model_udf(_udf(arch), arch=arch, reduced=True, device="cpu",
                       params=params)
    return arch, res["entities"], state


@pytest.fixture(scope="module")
def jax_answer():
    return _answer(ARCH)


@pytest.fixture(scope="module")
def jax_rwkv_answer():
    return _answer(RWKV_ARCH)


@pytest.mark.parametrize("route", ROUTES)
def test_model_udf_route_matches_jax_engine(jax_answer, route):
    _check_route(jax_answer, route)


@pytest.mark.parametrize("route", ROUTES)
def test_rwkv_model_udf_route_matches_jax_engine(jax_rwkv_answer, route):
    _check_route(jax_rwkv_answer, route)


def _check_route(answer, route):
    arch, want, state = answer
    eng = VDMSAsyncEngine(device="cpu", num_native_workers=2,
                          **_route(arch, route))
    try:
        eids = ingest_reference_state(eng, state)
        res = eng.execute(_query(arch), timeout=600)
        stats = eng.dispatch_stats()
    finally:
        eng.shutdown()
    assert res["stats"]["failed"] == 0
    assert list(res["entities"]) == list(want) == eids
    for eid in want:
        np.testing.assert_array_equal(res["entities"][eid],
                                      np.asarray(want[eid]))
    if route != "per_entity":
        placed = "device" if route == "device_backend" else "batcher"
        assert stats["placements"][placed] == len(eids)


def test_prompt_tokens_equal_jax_feats():
    """``feats_of``: truncate ``img*255`` to int32, float32 mean over H
    and W, clip, truncate — as the JAX package computes it on a device
    array, to the integer."""
    cfg = get_arch(ARCH, reduced=True)
    rng = np.random.default_rng(4)
    imgs = _images(4) + [rng.uniform(0, 1, (250, 250, 3)).astype(np.float32),
                         np.full((8, 8, 3), 0.999, np.float32),
                         np.full((4, 4, 3), 2.5, np.float32)]
    for img in imgs:
        x = jnp.asarray(img)
        want = jnp.clip((x * 255).astype(jnp.int32).mean(axis=(0, 1)),
                        0, cfg.vocab_size - 1).astype(jnp.int32)
        got = prompt_tokens(torch.from_numpy(img), cfg.vocab_size)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_unregister_udf_drops_every_route():
    """``unregister_udf`` removes a model UDF's per-entity, batched and
    device functions (and the parameters they hold)."""
    from repro_torch.core import udf
    register_model_udf("torch_dropped", arch=ARCH, reduced=True,
                       device="cpu")
    assert udf.has_batched_udf("torch_dropped")
    assert udf.has_device_udf("torch_dropped")
    udf.unregister_udf("torch_dropped")
    assert not udf.has_batched_udf("torch_dropped")
    assert not udf.has_device_udf("torch_dropped")
    with pytest.raises(KeyError, match="not registered"):
        udf.get_udf("torch_dropped")
    udf.unregister_udf("torch_dropped")  # unknown names are ignored
