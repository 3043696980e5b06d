"""The port's MoE, encoder-decoder and vit_stub pieces held against the
JAX package on the CPU, layer by layer and through the serving layer.

- ``apply_moe`` alone on reduced granite-moe, at capacity factor 4.0 (no
  token dropped) and 1.0 (tokens dropped): the same top-k experts, the
  same kept slots, the output and the load-balancing loss;
- the transformer block with GELU MLP, LayerNorm and cross-attention
  (whisper's), with the encoder output and with a cross cache, and a
  MoE block;
- reduced whisper with 1,100 encoder frames: the encoder's
  self-attention and the decoder's cross-attention take the chunked
  flash route in both packages;
- ``launch/model_serve.run`` and ``GroupBatcher`` for whisper and
  internvl2 on the JAX launcher's weights;
- the model UDF: internvl2's per-entity route (patch embeddings from the
  image) and whisper's grouped and device routes stamp the reference's
  images;
- ``params_from_jax`` refuses an encoder-decoder or MoE tree of another
  layout.

Tolerances (absolute, float32): logits 3e-4 (the JAX package's own
between its prefill or decode and its forward, ``tests/test_models.py``);
layer outputs and caches 1e-4 (a few float32 products summed in another
order, on values of order one); the load-balancing loss and routing
weights 1e-6; the GELU MLP alone 1e-5 (two float32 products of 64 and
128 terms; the tanh form lands about 4e-4 away); expert choices, kept slots, tokens and stamped images
equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.distributed.sharding import REPLICATED as JAX_REPLICATED
from repro.models import common as jcommon
from repro.models import get_model as jax_model
from repro_torch.configs import get_arch
from repro_torch.distributed.sharding import REPLICATED
from repro_torch.interop import params_from_jax
from repro_torch.models import get_model

torch.set_num_threads(1)

LOGIT_TOL = 3e-4
STATE_TOL = 1e-4
AUX_TOL = 1e-6
GELU_TOL = 1e-5
MOE_ARCH = "granite-moe-1b-a400m"
ENCDEC_ARCH = "whisper-small"
VLM_ARCH = "internvl2-1b"


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol, rtol=0)


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _jax_weights(arch, seed=0, **replace):
    """(JAX api, JAX params, port api, port params) of a reduced arch."""
    jcfg = jax_arch(arch, reduced=True).replace(**replace)
    japi = jax_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(seed))
    cfg = get_arch(arch, reduced=True).replace(**replace)
    return (japi, jparams, get_model(cfg),
            params_from_jax(_np_tree(jparams), cfg, device="cpu"))


# ------------------------------------------------------------------ MoE
def _jax_kept(top_e, E, C):
    """The reference's slot assignment (stable sort by expert, position
    from the counts' exclusive cumsum, kept below C), in numpy."""
    flat = np.asarray(top_e).reshape(-1)
    order = np.argsort(flat, kind="stable")
    sorted_e = flat[order]
    counts = np.bincount(sorted_e, minlength=E)
    pos = np.arange(flat.size) - (np.cumsum(counts) - counts)[sorted_e]
    return order, pos < C


@pytest.mark.parametrize("cf,drops", [(4.0, False), (1.0, True)],
                         ids=["cf4-no-drops", "cf1-drops"])
def test_apply_moe_matches_jax(cf, drops):
    from repro.models.moe import _local_topk_route
    from repro.models.moe import apply_moe as jax_apply_moe
    from repro.models.moe import init_moe as jax_init_moe
    from repro_torch.models import moe
    jcfg = jax_arch(MOE_ARCH, reduced=True)
    cfg = get_arch(MOE_ARCH, reduced=True)
    jp = jax_init_moe(jcommon.KeyGen(jax.random.PRNGKey(3)), jcfg,
                      jnp.float32)
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = _normal(4, (2, 24, cfg.d_model))
    T, E, K = 48, cfg.num_experts, cfg.num_experts_per_tok
    C = moe.capacity(cfg, T, cf)
    assert C == max(8, int(np.ceil(cf * T * K / E)))

    jw, je, jaux = _local_topk_route(jnp.asarray(x).reshape(T, -1),
                                     jp["router"], E, K, cf,
                                     jcfg.router_aux_loss_coef, jnp.float32)
    w, e, aux = moe.route(p["router"], torch.from_numpy(x).reshape(T, -1),
                          cfg)
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    _close(w, jw, AUX_TOL)
    _close(aux, jaux, AUX_TOL)

    order, slot, keep = moe.dispatch(e, E, C)
    jorder, jkeep = _jax_kept(je, E, C)
    np.testing.assert_array_equal(order.numpy(), jorder)
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    assert bool((~keep).any()) == drops
    assert bool((slot[~keep] == E * C).all())
    assert len(set(slot[keep].tolist())) == int(keep.sum())

    want, jaux2 = jax_apply_moe(jp, jnp.asarray(x), cfg=jcfg,
                                sh=JAX_REPLICATED, capacity_factor=cf)
    got, aux2 = moe.apply_moe(p, torch.from_numpy(x), cfg=cfg,
                              sh=REPLICATED, capacity_factor=cf)
    _close(got, want, STATE_TOL)
    _close(aux2, jaux2, AUX_TOL)
    if drops:  # a dropped choice adds nothing: the output differs from cf 4
        full, _ = moe.apply_moe(p, torch.from_numpy(x), cfg=cfg,
                                sh=REPLICATED, capacity_factor=4.0)
        assert float((full - got).abs().max()) > 1e-3


# --------------------------------------------------------------- blocks
def _perturbed(tree, seed):
    """Norm scales and biases moved off 1 and 0, so every branch shows."""
    rng = np.random.default_rng(seed)

    def move(path, leaf):
        name = path[-1].key
        if name.startswith(("ln", "b_", "b")) and leaf.ndim == 1:
            return leaf + 0.1 * rng.standard_normal(leaf.shape).astype(
                np.float32)
        return leaf
    return jax.tree_util.tree_map_with_path(move, _np_tree(tree))


@pytest.mark.parametrize("kind", ["gelu-layer-cross", "moe"])
def test_transformer_block_variants_match_jax(kind):
    """Whisper's decoder block (GELU MLP, LayerNorm with biases,
    cross-attention over an encoder output, then the same against a
    cross cache at decode) and a MoE block (RMSNorm, routed experts)."""
    from repro.models import attention as jattention
    from repro.models import blocks as jblocks
    from repro_torch.models import attention, blocks
    from repro_torch.models.lm import tree_map
    arch = ENCDEC_ARCH if kind != "moe" else MOE_ARCH
    jcfg, cfg = jax_arch(arch, reduced=True), get_arch(arch, reduced=True)
    kw = (dict(cross=True, mlp_kind="gelu", norm="layer") if kind != "moe"
          else dict(use_moe=True))
    jp = _perturbed(jblocks.init_tblock(
        jcommon.KeyGen(jax.random.PRNGKey(5)), jcfg, jnp.float32, **kw), 6)
    p = tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
    apply_kw = {k: v for k, v in kw.items() if k != "cross"}
    x = _normal(7, (2, 10, cfg.d_model))
    enc = _normal(8, (2, 12, cfg.d_model)) if kind != "moe" else None
    jenc = None if enc is None else jnp.asarray(enc)
    tenc = None if enc is None else torch.from_numpy(enc)
    want, _, jaux = jblocks.apply_tblock(jp, jnp.asarray(x), cfg=jcfg,
                                         sh=JAX_REPLICATED, enc=jenc,
                                         **apply_kw)
    got, _, aux = blocks.apply_tblock(p, torch.from_numpy(x), cfg=cfg,
                                      sh=REPLICATED, enc=tenc, **apply_kw)
    _close(got, want, STATE_TOL)
    _close(aux, jaux, AUX_TOL)
    if kind == "moe":
        assert float(aux) > 0
        return
    # one decode step against a self cache of 9 slots and the cross cache
    hd, kv = cfg.resolved_head_dim, cfg.num_kv_heads
    jxc = jattention.make_cross_cache(jp["xattn"], jenc, jcfg,
                                      JAX_REPLICATED)
    xc = attention.make_cross_cache(p["xattn"], tenc, cfg, REPLICATED)
    for key in ("k", "v"):
        _close(xc[key], jxc[key], STATE_TOL)
    kvc = _normal(9, (2, 2, 12, kv, hd), 0.5)
    want, jkv, _ = jblocks.apply_tblock(
        jp, jnp.asarray(x[:, :1]), cfg=jcfg, sh=JAX_REPLICATED,
        kv_cache={"k": jnp.asarray(kvc[0]), "v": jnp.asarray(kvc[1])},
        cache_index=jnp.int32(9), cross_cache=jxc, **apply_kw)
    tkv = {"k": torch.from_numpy(kvc[0].copy()),
           "v": torch.from_numpy(kvc[1].copy())}
    got, out, _ = blocks.apply_tblock(
        p, torch.from_numpy(x[:, :1]), cfg=cfg, sh=REPLICATED, kv_cache=tkv,
        cache_index=9, cross_cache=xc, **apply_kw)
    assert out is tkv
    _close(got, want, STATE_TOL)
    for key in ("k", "v"):
        _close(tkv[key], jkv[key], STATE_TOL)


def test_gelu_mlp_is_the_exact_erf_form():
    from repro.models.mlp import apply_mlp as jax_apply_mlp
    from repro.models.mlp import init_mlp as jax_init_mlp
    from repro_torch.models.mlp import apply_mlp
    jcfg = jax_arch(ENCDEC_ARCH, reduced=True)
    jp = _perturbed(jax_init_mlp(jcommon.KeyGen(jax.random.PRNGKey(1)), jcfg,
                                 jnp.float32, kind="gelu"), 2)
    x = _normal(3, (2, 5, jcfg.d_model), 3.0)
    want = jax_apply_mlp(jp, jnp.asarray(x), sh=JAX_REPLICATED, kind="gelu")
    got = apply_mlp({k: torch.from_numpy(v) for k, v in jp.items()},
                    torch.from_numpy(x), sh=REPLICATED, kind="gelu")
    _close(got, want, GELU_TOL)
    tanh = jax.nn.gelu(jnp.asarray(x) @ jp["w_in"] + jp["b_in"],
                       approximate=True) @ jp["w_out"] + jp["b_out"]
    assert float(np.abs(np.asarray(tanh) - got.numpy()).max()) > 10 * GELU_TOL


# ------------------------------------------------- the chunked route
def test_cross_attention_takes_the_flash_route_as_jax(monkeypatch):
    """Reduced whisper with 1,100 encoder frames: every encoder layer's
    self-attention and every decoder layer's cross-attention (24 rows
    against 1,100 keys) take the chunked flash route in both packages;
    the forward, a prefill and one decode step agree."""
    import repro.kernels.flash_vjp as jflash
    import repro_torch.models.attention as tattention
    calls = {"jax": [], "port": []}
    jfn, tfn = jflash.flash_attention, tattention.flash_vjp

    def jspy(q, k, *a, **kw):
        calls["jax"].append((q.shape[1], k.shape[1], a[1]))
        return jfn(q, k, *a, **kw)

    def tspy(q, k, *a, **kw):
        calls["port"].append((q.shape[1], k.shape[1], a[1]))
        return tfn(q, k, *a, **kw)

    monkeypatch.setattr(jflash, "flash_attention", jspy)
    monkeypatch.setattr(tattention, "flash_vjp", tspy)
    japi, jparams, api, params = _jax_weights(ENCDEC_ARCH, 11,
                                              encoder_seq_len=1100)
    cfg = api.cfg
    toks = np.random.default_rng(12).integers(
        0, cfg.vocab_size, (1, 25)).astype(np.int32)
    frames = _normal(13, (1, 1100, cfg.d_model), 0.1)
    jb = {"tokens": jnp.asarray(toks[:, :24]), "frames": jnp.asarray(frames)}
    tb = {"tokens": torch.from_numpy(toks[:, :24]),
          "frames": torch.from_numpy(frames)}
    want, _ = japi.forward(jparams, jb, JAX_REPLICATED)
    got, _ = api.forward(params, tb, REPLICATED)
    _close(got, want, LOGIT_TOL)
    # the port calls it per layer; the reference traces each scan's body
    # once
    routes = [(1100, 1100, False), (24, 1100, False)]
    expect = [routes[0]] * cfg.num_encoder_layers + \
        [routes[1]] * cfg.num_layers
    assert calls["port"] == expect and calls["jax"] == routes
    want, jcache = japi.prefill(jparams, jb, JAX_REPLICATED, max_cache=30)
    got, cache = api.prefill(params, tb, REPLICATED, 30)
    _close(got, want, LOGIT_TOL)
    for key in jcache:
        assert tuple(cache[key].shape) == jcache[key].shape
        _close(cache[key], jcache[key], STATE_TOL)
    assert calls["port"] == expect * 2 and calls["jax"] == routes * 2
    want, _ = japi.decode_step(jparams, jnp.asarray(toks[:, 24:]), jcache,
                               jnp.int32(24), JAX_REPLICATED)
    got, _ = api.decode_step(params, torch.from_numpy(toks[:, 24:]), cache,
                             24, REPLICATED)
    _close(got, want, LOGIT_TOL)


# ------------------------------------------------------ serving layer
@pytest.mark.parametrize("arch", [ENCDEC_ARCH, VLM_ARCH])
def test_model_serve_run_matches_jax(arch):
    """``launch/model_serve.run`` on the CPU with the JAX launcher's
    weights (frames or patch embeddings of 0.01, decode from ``P +
    prompt_len``) generates the JAX launcher's tokens."""
    from repro.launch.model_serve import run as jax_run
    from repro_torch.launch.model_serve import run
    want = jax_run(arch, reduced=True, requests=2, prompt_len=8, gen=4)
    _, _, _, params = _jax_weights(arch)
    got = run(arch, reduced=True, requests=2, prompt_len=8, gen=4,
              device="cpu", params=params)
    np.testing.assert_array_equal(got["generated"], want["generated"])
    assert got["tokens_per_s"] > 0 and got["prefill_s"] > 0


@pytest.mark.parametrize("arch", [ENCDEC_ARCH, VLM_ARCH])
def test_group_batcher_matches_jax(arch):
    """The port's GroupBatcher and the JAX package's, on the same
    weights and prompts of two lengths, return each request the same
    tokens (zero frames or patch embeddings per group)."""
    from repro.serving.batcher import GroupBatcher as JaxBatcher
    from repro_torch.serving.batcher import GroupBatcher
    japi, jparams, api, params = _jax_weights(arch, 2)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, api.cfg.vocab_size, n).astype(np.int32)
               for n in (4, 4, 6)]
    got_b = GroupBatcher(api, params, group_size=2, max_new_default=3)
    want_b = JaxBatcher(japi, jparams, group_size=2, max_new_default=3)
    got = [got_b.submit(p) for p in prompts]
    want = [want_b.submit(p) for p in prompts]
    got_b.run_until_idle()
    want_b.run_until_idle()
    assert got_b.groups_run == want_b.groups_run == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.result(5), w.result(5))


# ------------------------------------------------------------ model UDF
def _udf_images(n):
    rng = np.random.default_rng(21)
    shapes = [(24, 24, 3), (32, 40, 3), (17, 23, 3), (48, 48, 3)]
    return [rng.uniform(0, 1, shapes[i % len(shapes)]).astype(np.float32)
            for i in range(n)]


@pytest.fixture(scope="module", params=[VLM_ARCH, ENCDEC_ARCH])
def udf_pair(request):
    """One model UDF registered in each package on the same weights (the
    JAX one's ``PRNGKey(0)`` tree)."""
    from repro.core import udf as judf
    from repro_torch.core import udf
    arch = request.param
    name = f"torch_family_{arch}"
    judf.register_model_udf(name, arch=arch, reduced=True)
    _, _, _, params = _jax_weights(arch)
    udf.register_model_udf(name, arch=arch, reduced=True, device="cpu",
                           params=params)
    yield arch, name, judf, udf
    udf.unregister_udf(name)


def test_model_udf_registers_the_reference_routes(udf_pair):
    """internvl2 (vit_stub) registers the per-entity route alone; whisper
    all three, and its per-entity route raises ``KeyError('frames')`` in
    both packages (the reference builds no frames there)."""
    arch, name, judf, udf = udf_pair
    for mod in (judf, udf):
        assert mod.has_batched_udf(name) == (arch == ENCDEC_ARCH)
        assert mod.has_device_udf(name) == (arch == ENCDEC_ARCH)
    if arch == ENCDEC_ARCH:
        img = _udf_images(1)[0]
        with pytest.raises(KeyError, match="frames"):
            judf.get_udf(name)(jnp.asarray(img))
        with pytest.raises(KeyError, match="frames"):
            udf.get_udf(name)(torch.from_numpy(img))


def test_model_udf_stamps_the_reference_images(udf_pair):
    """internvl2's per-entity route (patch embeddings resized from the
    image) and whisper's grouped and device routes (zero frames) stamp
    the JAX package's images exactly."""
    arch, name, judf, udf = udf_pair
    imgs = _udf_images(4)
    if arch == VLM_ARCH:
        want = [judf.get_udf(name)(jnp.asarray(i)) for i in imgs]
        got = [udf.get_udf(name)(torch.from_numpy(i)) for i in imgs]
        pairs = [(got, want)]
    else:
        pairs = []
        for reg in ("get_batched_udf", "get_device_udf"):
            want = getattr(judf, reg)(name)([jnp.asarray(i) for i in imgs])
            got = getattr(udf, reg)(name)([torch.from_numpy(i) for i in imgs])
            pairs.append((got, want))
    for got, want in pairs:
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_vit_stub_patch_embeddings_match_jax():
    from repro_torch.core.udf import patch_embeds
    cfg = get_arch(VLM_ARCH, reduced=True)
    full = get_arch(VLM_ARCH)
    for img in _udf_images(3):
        for c in (cfg, full):   # 8 patches (shrinks), 256 (grows)
            P = c.num_patches
            pe = jax.image.resize(jnp.asarray(img), (P, 8, 3),
                                  "linear").reshape(P, -1)
            pe = jnp.tile(pe, (1, c.d_model // pe.shape[-1] + 1))[
                :, :c.d_model]
            got = patch_embeds(torch.from_numpy(img), c)
            assert tuple(got.shape) == (P, c.d_model)
            _close(got, pe * 0.02, 1e-7)


# -------------------------------------------------------------- interop
def test_params_from_jax_checks_encdec_and_moe_layouts():
    _, jparams, api, _ = _jax_weights(ENCDEC_ARCH)
    cfg = api.cfg
    tree = _np_tree(jparams)
    missing = {k: v for k, v in tree.items() if k != "enc_norm_b"}
    with pytest.raises(ValueError, match="top-level keys"):
        params_from_jax(missing, cfg, device="cpu")
    shallow = dict(tree, dec_blocks=jax.tree.map(lambda a: a[:1],
                                                 tree["dec_blocks"]))
    with pytest.raises(ValueError, match="not stacked"):
        params_from_jax(shallow, cfg, device="cpu")
    _, jparams, api, _ = _jax_weights(MOE_ARCH)
    tree = _np_tree(jparams)
    moe = dict(tree["blocks"]["moe"],
               w_up=tree["blocks"]["moe"]["w_up"][:, :3])
    few = dict(tree, blocks=dict(tree["blocks"], moe=moe))
    with pytest.raises(ValueError, match="experts"):
        params_from_jax(few, api.cfg, device="cpu")
