"""The PyTorch port's model path held against the JAX package on the CPU.

Reduced ``zamba2-2.7b`` (hybrid: Mamba2 trunk, the SSD scan, shared
attention blocks), ``qwen3-0.6b`` (dense: GQA, qk_norm), ``minicpm-2b``
(dense: the depth-scaled residual, mup embedding and logit scaling),
``granite-8b`` (dense: GQA at rope theta 1e7), ``qwen1.5-32b`` (dense:
QKV bias, MHA), ``rwkv6-1.6b``
(rwkv: token shift, data-dependent decay, the WKV6 scan),
``granite-moe-1b-a400m`` and ``qwen3-moe-235b-a22b`` (moe: top-k
routing, sort-based dispatch; the reduced configs' capacity factor 4.0
drops no token), ``whisper-small`` (the encoder-decoder: GELU,
LayerNorm, cross-attention, sinusoidal positions) and ``internvl2-1b``
(vlm: QKV bias, ``vit_stub`` patch embeddings ahead of the tokens) are
built from one JAX parameter tree, carried into the port by
``repro_torch.interop.params_from_jax``; the same numpy tokens (and
numpy-seeded frames or patch embeddings) go through both.

Tolerances (absolute, float32):
- logits 3e-4 — the JAX package's own tolerance between its prefill or
  decode and its forward (``tests/test_models.py``); a few layers of
  float32 products summed in another order stay far inside it;
- caches and layer outputs 1e-4 — the same arithmetic, one to six layers
  deep, on values of order one;
- norms, rope and positions 1e-6 — elementwise float32;
- the MoE load-balancing loss 1e-6 — a float32 sum of E products of
  means over a few dozen tokens;
- greedy tokens: equal.
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
from repro.models.mamba2 import apply_mamba2 as jax_apply_mamba2
from repro.models.mamba2 import init_mamba2 as jax_init_mamba2
from repro.models.rope import apply_rope as jax_apply_rope
from repro.serving.serve_step import greedy_generate as jax_generate
from repro_torch.configs import get_arch
from repro_torch.distributed.sharding import REPLICATED, ShardingCtx
from repro_torch.interop import params_from_jax
from repro_torch.models import common, get_model
from repro_torch.models.mamba2 import apply_mamba2, conv_dim
from repro_torch.models.registry import token_start
from repro_torch.models.rope import apply_rope
from repro_torch.serving.serve_step import greedy_generate

torch.set_num_threads(1)

ARCHS = ["zamba2-2.7b", "qwen3-0.6b", "rwkv6-1.6b", "granite-moe-1b-a400m",
         "qwen3-moe-235b-a22b", "whisper-small", "internvl2-1b",
         "minicpm-2b", "granite-8b", "qwen1.5-32b"]
LOGIT_TOL = 3e-4
STATE_TOL = 1e-4
ELEM_TOL = 1e-6
AUX_TOL = 1e-6
B, S = 2, 24


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(arch, JAX api, JAX params, port api, port params)."""
    arch = request.param
    jcfg = jax_arch(arch, reduced=True)
    japi = jax_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(7))
    cfg = get_arch(arch, reduced=True)
    params = params_from_jax(_np_tree(jparams), cfg, device="cpu")
    return arch, japi, jparams, get_model(cfg), params


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _extras(cfg, batch, seed):
    """The inputs besides tokens a config asks for, numpy-seeded: a
    vit_stub model's patch embeddings, an encoder-decoder's frames."""
    rng = np.random.default_rng(100 + seed)
    out = {}
    if token_start(cfg):
        out["patch_embeds"] = (rng.standard_normal(
            (batch, cfg.num_patches, cfg.d_model)) * 0.1).astype(np.float32)
    if cfg.is_encoder_decoder:
        out["frames"] = (rng.standard_normal(
            (batch, cfg.encoder_seq_len, cfg.d_model)) * 0.1).astype(np.float32)
    return out


def _batches(cfg, toks, seed):
    """The same batch for the JAX package and for the port."""
    b = {"tokens": toks, **_extras(cfg, toks.shape[0], seed)}
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol, rtol=0)


# ---------------------------------------------------------------- model
def test_configs_match_the_reference():
    for arch in ARCHS:
        for reduced in (False, True):
            assert get_arch(arch, reduced).__dict__ == \
                jax_arch(arch, reduced).__dict__
    for arch in ARCHS:
        assert get_arch(arch).param_count() == jax_arch(arch).param_count()
        assert get_arch(arch).active_param_count() == \
            jax_arch(arch).active_param_count()


def test_forward_matches_jax(pair):
    _, japi, jparams, api, params = pair
    jb, tb = _batches(api.cfg, _tokens(api.cfg, (B, S), 1), 1)
    want, jaux = japi.forward(jparams, jb, JAX_REPLICATED)
    got, aux = api.forward(params, tb, REPLICATED)
    assert got.shape == (B, token_start(api.cfg) + S, api.cfg.padded_vocab)
    _close(got, want, LOGIT_TOL)
    if api.cfg.is_moe:
        assert float(aux) > 0.0
        _close(aux, jaux, AUX_TOL)
    else:
        assert float(aux) == 0.0


def test_prefill_logits_and_cache_match_jax(pair):
    _, japi, jparams, api, params = pair
    jb, tb = _batches(api.cfg, _tokens(api.cfg, (B, S), 2), 2)
    P = token_start(api.cfg)
    want, jcache = japi.prefill(jparams, jb, JAX_REPLICATED,
                                max_cache=P + S + 6)
    got, cache = api.prefill(params, tb, REPLICATED, P + S + 6)
    _close(got, want, LOGIT_TOL)
    assert set(cache) == set(jcache)
    for key in jcache:
        assert tuple(cache[key].shape) == jcache[key].shape
        assert str(cache[key].dtype).split(".")[-1] == str(jcache[key].dtype)
        _close(cache[key], jcache[key], STATE_TOL)


def test_four_decode_steps_match_jax(pair):
    _, japi, jparams, api, params = pair
    toks = _tokens(api.cfg, (B, S + 4), 3)
    jb, tb = _batches(api.cfg, toks[:, :S], 3)
    P = token_start(api.cfg)
    _, jcache = japi.prefill(jparams, jb, JAX_REPLICATED,
                             max_cache=P + S + 5)
    _, cache = api.prefill(params, tb, REPLICATED, P + S + 5)
    for i in range(4):
        step = toks[:, S + i:S + i + 1]
        want, jcache = japi.decode_step(jparams, jnp.asarray(step), jcache,
                                        jnp.int32(P + S + i), JAX_REPLICATED)
        got, cache = api.decode_step(params, torch.from_numpy(step), cache,
                                     P + S + i, REPLICATED)
        _close(got, want, LOGIT_TOL)
    for key in jcache:
        _close(cache[key], jcache[key], STATE_TOL)


def test_greedy_tokens_match_jax(pair):
    _, japi, jparams, api, params = pair
    jb, tb = _batches(api.cfg, _tokens(api.cfg, (3, 5), 4), 4)
    want = jax_generate(japi, jparams, jb, steps=6, sh=JAX_REPLICATED)
    got = greedy_generate(api, params, tb, steps=6, sh=REPLICATED)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prefill_and_decode_match_forward_in_the_port(pair):
    """``tests/test_models.py``'s consistency checks, inside the port:
    prefill's last logits and four decode steps equal the no-cache
    forward at the same positions."""
    _, _, _, api, params = pair
    _, batch = _batches(api.cfg, _tokens(api.cfg, (B, S + 4), 5), 5)
    toks, P = batch["tokens"], token_start(api.cfg)
    full, _ = api.forward(params, batch, REPLICATED)
    lg, cache = api.prefill(params, {**batch, "tokens": toks[:, :S]},
                            REPLICATED, P + S + 5)
    _close(lg, full[:, P + S - 1], LOGIT_TOL)
    for i in range(4):
        lg, cache = api.decode_step(params, toks[:, S + i:S + i + 1], cache,
                                    P + S + i, REPLICATED)
        _close(lg, full[:, P + S + i], LOGIT_TOL)


def test_port_init_is_seeded_and_shaped_as_the_reference(pair):
    _, _, jparams, api, params = pair
    mine = api.init(torch.Generator().manual_seed(3))
    again = api.init(torch.Generator().manual_seed(3))
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    for path, leaf in flat_j:
        keys = [p.key for p in path]
        a, b = mine, again
        for k in keys:
            a, b = a[k], b[k]
        assert tuple(a.shape) == leaf.shape, keys
        assert torch.equal(a, b)
        assert bool(torch.isfinite(a).all())
    w = mine["embed"]
    assert float(w.abs().max()) <= 3 * 0.02 + 1e-6
    assert abs(float(w.std()) / (0.02 * 0.9866) - 1) < 0.02  # trunc. at 3 sd


# --------------------------------------------------------------- layers
def test_mamba2_layer_and_decode_step_match_jax():
    """One Mamba2 mixer on 8 tokens with a cache, then the same tokens one
    at a time through the O(1) decode step (``tests/test_kernels.py``'s
    decode-matches-scan check), against the JAX package."""
    jcfg = jax_arch("zamba2-2.7b", reduced=True)
    cfg = get_arch("zamba2-2.7b", reduced=True)
    jp = jax_init_mamba2(jcommon.KeyGen(jax.random.PRNGKey(0)), jcfg,
                         jnp.float32)
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = (np.random.default_rng(1).standard_normal((1, 8, cfg.d_model))
         * 0.3).astype(np.float32)
    cd, W = conv_dim(cfg), cfg.mamba_conv_width
    H, P, N = cfg.mamba_nheads, cfg.mamba_head_dim, cfg.ssm_state
    jy, jconv, jssm = jax_apply_mamba2(
        jp, jnp.asarray(x), cfg=jcfg, sh=JAX_REPLICATED,
        conv_state=jnp.zeros((1, W - 1, cd)), ssm_state=jnp.zeros((1, H, P, N)))
    y, conv, ssm = apply_mamba2(p, torch.from_numpy(x), cfg=cfg, sh=REPLICATED,
                                conv_state=torch.zeros(1, W - 1, cd),
                                ssm_state=torch.zeros(1, H, P, N))
    for got, want in ((y, jy), (conv, jconv), (ssm, jssm)):
        _close(got, want, STATE_TOL)
    c, s = torch.zeros(1, W - 1, cd), torch.zeros(1, H, P, N)
    steps = []
    for t in range(8):
        yt, c, s = apply_mamba2(p, torch.from_numpy(x[:, t:t + 1]), cfg=cfg,
                                sh=REPLICATED, conv_state=c, ssm_state=s)
        steps.append(yt)
    _close(torch.cat(steps, dim=1), jy, 2e-4)
    _close(s, jssm, 2e-4)
    y_nc, c_nc, s_nc = apply_mamba2(p, torch.from_numpy(x), cfg=cfg,
                                    sh=REPLICATED)
    assert c_nc is None and s_nc is None
    _close(y_nc, jy, STATE_TOL)


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_attention_branches_match_jax(qkv_bias):
    """qwen3's qk_norm and GQA, with and without QKV bias, in all three
    modes: no cache, prefill into the cache, and one decode step."""
    from repro.models.attention import apply_attention as jax_attn
    from repro.models.attention import init_attention as jax_init_attn
    from repro_torch.models.attention import apply_attention
    jcfg = jax_arch("qwen3-0.6b", reduced=True).replace(qkv_bias=qkv_bias)
    cfg = get_arch("qwen3-0.6b", reduced=True).replace(qkv_bias=qkv_bias)
    jp = jax_init_attn(jcommon.KeyGen(jax.random.PRNGKey(2)), jcfg,
                       jnp.float32)
    if qkv_bias:  # non-zero biases, so the branch shows
        rng = np.random.default_rng(9)
        jp = {k: (v + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
                  if k.startswith("b") else v) for k, v in jp.items()}
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.default_rng(3).standard_normal(
        (B, 10, cfg.d_model)).astype(np.float32)
    want, _ = jax_attn(jp, jnp.asarray(x), cfg=jcfg, sh=JAX_REPLICATED)
    got, cache = apply_attention(p, torch.from_numpy(x), cfg=cfg,
                                 sh=REPLICATED)
    assert cache is None
    _close(got, want, STATE_TOL)
    hd, kv = cfg.resolved_head_dim, cfg.num_kv_heads
    jkv = {"k": jnp.zeros((B, 16, kv, hd)), "v": jnp.zeros((B, 16, kv, hd))}
    kvc = {"k": torch.zeros(B, 16, kv, hd), "v": torch.zeros(B, 16, kv, hd)}
    want, jkv = jax_attn(jp, jnp.asarray(x[:, :9]), cfg=jcfg,
                         sh=JAX_REPLICATED, kv_cache=jkv, cache_index=0)
    got, out = apply_attention(p, torch.from_numpy(x[:, :9]), cfg=cfg,
                               sh=REPLICATED, kv_cache=kvc, cache_index=0)
    assert out is kvc
    _close(got, want, STATE_TOL)
    want, jkv = jax_attn(jp, jnp.asarray(x[:, 9:]), cfg=jcfg,
                         sh=JAX_REPLICATED, kv_cache=jkv,
                         cache_index=jnp.int32(9))
    got, kvc = apply_attention(p, torch.from_numpy(x[:, 9:]), cfg=cfg,
                               sh=REPLICATED, kv_cache=kvc, cache_index=9)
    _close(got, want, STATE_TOL)
    for key in ("k", "v"):
        _close(kvc[key], jkv[key], STATE_TOL)


@pytest.mark.parametrize("cached", [False, True])
def test_rwkv6_layer_matches_jax(cached):
    """One RWKV6 block on 8 tokens, with no cache and with a zero state
    (the chunked scan), against the JAX package; with a cache, the same
    tokens one at a time through the cached single-token step (the
    sequential scan) give the same outputs and states."""
    from repro.models.rwkv6 import apply_rwkv6 as jax_apply_rwkv6
    from repro.models.rwkv6 import init_rwkv6 as jax_init_rwkv6
    from repro_torch.models.rwkv6 import apply_rwkv6
    jcfg = jax_arch("rwkv6-1.6b", reduced=True)
    cfg = get_arch("rwkv6-1.6b", reduced=True)
    jp = jax_init_rwkv6(jcommon.KeyGen(jax.random.PRNGKey(0)), jcfg,
                        jnp.float32)
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = (np.random.default_rng(1).standard_normal((2, 8, cfg.d_model))
         * 0.3).astype(np.float32)
    H, K = cfg.rwkv_nheads, cfg.rwkv_head_dim

    def zero(mod):
        return {"tm_x": mod.zeros((2, cfg.d_model)),
                "cm_x": mod.zeros((2, cfg.d_model)),
                "wkv": mod.zeros((2, H, K, K))}

    jcache = zero(jnp) if cached else None
    jy, jst = jax_apply_rwkv6(jp, jnp.asarray(x), cfg=jcfg, sh=JAX_REPLICATED,
                              cache=jcache)
    y, st = apply_rwkv6(p, torch.from_numpy(x), cfg=cfg, sh=REPLICATED,
                        cache=zero(torch) if cached else None)
    _close(y, jy, STATE_TOL)
    if not cached:
        assert st is None and jst is None
        return
    for key in jst:
        _close(st[key], jst[key], STATE_TOL)
    state, steps = zero(torch), []
    for t in range(8):
        yt, state = apply_rwkv6(p, torch.from_numpy(x[:, t:t + 1]), cfg=cfg,
                                sh=REPLICATED, cache=state)
        steps.append(yt)
    _close(torch.cat(steps, dim=1), jy, STATE_TOL)
    for key in jst:
        _close(state[key], jst[key], STATE_TOL)


def test_long_context_attention_takes_the_flash_route_as_jax():
    """Reduced qwen3 beyond 1024 positions: the forward over 1100 tokens
    and a prefill into a 1105-slot cache, then one decode step, take the
    chunked flash route (``flash_vjp``) in both packages."""
    jcfg = jax_arch("qwen3-0.6b", reduced=True)
    japi = jax_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(5))
    cfg = get_arch("qwen3-0.6b", reduced=True)
    api = get_model(cfg)
    params = params_from_jax(_np_tree(jparams), cfg, device="cpu")
    toks = _tokens(cfg, (1, 1101), 6)
    want, _ = japi.forward(jparams, {"tokens": jnp.asarray(toks[:, :1100])},
                           JAX_REPLICATED)
    got, _ = api.forward(params, {"tokens": torch.from_numpy(toks[:, :1100])},
                         REPLICATED)
    _close(got, want, LOGIT_TOL)
    want, jcache = japi.prefill(jparams, {"tokens": jnp.asarray(toks[:, :1100])},
                                JAX_REPLICATED, max_cache=1105)
    got, cache = api.prefill(params, {"tokens": torch.from_numpy(toks[:, :1100])},
                             REPLICATED, 1105)
    _close(got, want, LOGIT_TOL)
    for key in jcache:
        _close(cache[key], jcache[key], STATE_TOL)
    step = toks[:, 1100:]
    want, _ = japi.decode_step(jparams, jnp.asarray(step), jcache,
                               jnp.int32(1100), JAX_REPLICATED)
    got, _ = api.decode_step(params, torch.from_numpy(step), cache, 1100,
                             REPLICATED)
    _close(got, want, LOGIT_TOL)


def test_zamba2_at_head_dim_80_beyond_1024_positions_matches_jax():
    """Reduced zamba2 with the full model's attention head dim (80)
    beyond 1024 positions: the forward, a prefill into a 1105-slot cache
    and one decode step take the flash route in both packages (on a card
    the port's goes through K3 at D = 80)."""
    jcfg = jax_arch("zamba2-2.7b", reduced=True).replace(head_dim=80)
    cfg = get_arch("zamba2-2.7b", reduced=True).replace(head_dim=80)
    japi = jax_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(9))
    api = get_model(cfg)
    params = params_from_jax(_np_tree(jparams), cfg, device="cpu")
    toks = _tokens(cfg, (1, 1101), 10)
    head = toks[:, :1100]
    want, _ = japi.forward(jparams, {"tokens": jnp.asarray(head)},
                           JAX_REPLICATED)
    got, _ = api.forward(params, {"tokens": torch.from_numpy(head)},
                         REPLICATED)
    _close(got, want, LOGIT_TOL)
    want, jcache = japi.prefill(jparams, {"tokens": jnp.asarray(head)},
                                JAX_REPLICATED, max_cache=1105)
    got, cache = api.prefill(params, {"tokens": torch.from_numpy(head)},
                             REPLICATED, 1105)
    _close(got, want, LOGIT_TOL)
    step = toks[:, 1100:]
    want, _ = japi.decode_step(jparams, jnp.asarray(step), jcache,
                               jnp.int32(1100), JAX_REPLICATED)
    got, _ = api.decode_step(params, torch.from_numpy(step), cache, 1100,
                             REPLICATED)
    _close(got, want, LOGIT_TOL)


def test_norms_rope_and_positions_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    s, b = (rng.standard_normal(16).astype(np.float32) for _ in range(2))
    tx, ts, tb = map(torch.from_numpy, (x, s, b))
    jx, js, jb = map(jnp.asarray, (x, s, b))
    _close(common.rms_norm(tx, ts, 1e-6), jcommon.rms_norm(jx, js, 1e-6),
           ELEM_TOL)
    _close(common.layer_norm(tx, ts, tb, 1e-5),
           jcommon.layer_norm(jx, js, jb, 1e-5), ELEM_TOL)
    _close(common.group_norm(tx, ts, tb, 4, 1e-5),
           jcommon.group_norm(jx, js, jb, 4, 1e-5), ELEM_TOL)
    _close(common.swiglu(tx, tx.flip(-1)),
           jcommon.swiglu(jx, jx[..., ::-1]), ELEM_TOL)
    pos = np.arange(3, 8)
    _close(common.sinusoidal_positions(torch.from_numpy(pos), 32),
           jcommon.sinusoidal_positions(jnp.asarray(pos), 32), ELEM_TOL)
    for theta in (10_000.0, 1_000_000.0):
        # angles up to 7 rad: a few float32 ulps of the angle apart
        _close(apply_rope(tx, torch.from_numpy(pos), theta),
               jax_apply_rope(jx, jnp.asarray(pos), theta), 1e-5)


# ------------------------------------------------------- serving layer
def test_model_serve_run_matches_jax():
    """``launch/model_serve.run`` on the CPU with the JAX launcher's
    weights generates the JAX launcher's tokens."""
    from repro.launch.model_serve import run as jax_run
    from repro_torch.launch.model_serve import run
    want = jax_run("zamba2-2.7b", reduced=True, requests=2, prompt_len=8,
                   gen=4)
    jparams = jax_model(jax_arch("zamba2-2.7b", reduced=True)).init(
        jax.random.PRNGKey(0))
    cfg = get_arch("zamba2-2.7b", reduced=True)
    got = run("zamba2-2.7b", reduced=True, requests=2, prompt_len=8, gen=4,
              device="cpu",
              params=params_from_jax(_np_tree(jparams), cfg, device="cpu"))
    np.testing.assert_array_equal(got["generated"], want["generated"])
    assert got["tokens_per_s"] > 0 and got["prefill_s"] > 0


def test_group_batcher_matches_sequential_greedy():
    """The port's GroupBatcher, fed prompts of two lengths, returns each
    request the tokens of its own greedy generation."""
    from repro_torch.serving.batcher import GroupBatcher
    cfg = get_arch("qwen3-0.6b", reduced=True)
    api = get_model(cfg)
    params = api.init(torch.Generator().manual_seed(1))
    batcher = GroupBatcher(api, params, group_size=2, max_new_default=3)
    prompts = [_tokens(cfg, (n,), i) for i, n in enumerate((4, 4, 6, 4))]
    reqs = [batcher.submit(p) for p in prompts]
    batcher.run_until_idle()
    assert batcher.groups_run == 3 and batcher.tokens_out == 12
    for p, r in zip(prompts, reqs):
        want = greedy_generate(api, params, {"tokens": torch.from_numpy(p)[None]},
                               steps=3, sh=REPLICATED)
        np.testing.assert_array_equal(r.result(5), want[0].numpy())


# ------------------------------------------------- what is not ported
def test_unported_paths_raise_instead_of_running_something_else():
    """What cannot run raises: a mesh of several ranks without its
    process group cannot place a rank (tensor parallelism over a model
    axis above one rank runs, ``tests/test_torch_tensor_parallel.py``),
    and the production mesh needs its 256 ranks; an unknown arch raises.  Every
    assigned architecture is ported (the dense configs minicpm-2b,
    granite-8b and qwen1.5-32b are parity cases of ``ARCHS``), and
    ``model_par=2`` on one rank runs unsharded (the reference's clamp,
    held in ``tests/test_torch_training.py``)."""
    from repro_torch.distributed.sharding import Mesh
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("no-such-arch")
    sh = ShardingCtx(mesh=Mesh(("data", "model"), (2, 2)))
    assert sh.tp == 2
    with pytest.raises(ValueError, match="needs its DeviceMesh"):
        sh.model_index
    assert ShardingCtx(mesh=Mesh(("data", "model"), (4, 1))).mesh.size == 4
    from repro_torch.launch import train
    with pytest.raises(ValueError, match="256 ranks"):
        train.run("qwen3-0.6b", mesh_kind="production", device="cpu")
    cfg = get_arch("qwen3-0.6b", reduced=True)
    with pytest.raises(ValueError, match="top-level keys"):
        params_from_jax({"embed": np.zeros((1, 1))}, cfg)


def test_model_entry_points_refuse_cuda_on_a_host_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from repro_torch.core.udf import register_model_udf
    from repro_torch.launch.model_serve import run
    with pytest.raises(RuntimeError, match="no CUDA device"):
        register_model_udf("lm_refused", arch="qwen3-0.6b")  # cuda default
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run("qwen3-0.6b", requests=1, prompt_len=2, gen=1)
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.run("qwen3-0.6b", steps=1, batch=1, seq=4)     # cuda default
    cfg = get_arch("qwen3-0.6b", reduced=True)
    tree = get_model(cfg).init(torch.Generator().manual_seed(0))
    from repro_torch.models.lm import tree_map
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax(tree_map(lambda a: a.numpy(), tree), cfg)  # cuda
