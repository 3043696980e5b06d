"""The PyTorch port's training slice held against the JAX package on the
CPU: the optimizer and its schedules, one train step of every reduced
family from one JAX state carried across with
``interop.train_state_from_jax``, remat, microbatches, flash attention's
recomputing backward against ``jax.vjp`` of the reference's
``flash_vjp``, checkpoints across the two packages and the launcher
with a restart; then the scenarios of ``tests/test_training.py`` on the
port alone.

Tolerances:
- the schedule: 1e-6 relative (the port computes it in Python floats,
  the reference in float32: about 1e-7 apart);
- ``adamw_update``: 1e-6 absolute on values of order one — the same
  float32 formula leaf by leaf;
- one float32 train step (``compute_dtype`` and ``grad_reduce_dtype``
  float32, remat on): loss and gradient norm 1e-5 relative (float32
  sums in another order); moments 1e-5 of their largest magnitude; the
  parameters within ``lr · (1e-3 + |Δm| / ((1 - b1) · eps))`` of the
  reference's, elementwise.  At the first step from zero moments AdamW
  moves an element by ``lr · g / (|g| + eps)``, whose slope is
  ``1/eps``: a gradient near eps (1e-8) turns a float32 summation-order
  difference ``Δg = Δm / (1 - b1)`` into up to ``lr · Δg / eps``;
- one step at the defaults (bfloat16 compute, bfloat16 gradient
  rounding): loss 1e-3 relative and gradient norm 1e-2 relative (both
  packages round activations and gradients to bfloat16, in other
  places); the parameter updates within 0.5 of the reference's in
  relative L2 norm, and at most 5% of the elements more than
  ``1e-2 · lr`` apart — bfloat16 rounding flips the sign of gradient
  elements near zero, and AdamW's first step moves each element by
  about ±lr whatever its gradient's size (measured: 0.11–0.21 and
  0.5–1.8%);
- flash attention's gradients: 2e-4 absolute, the reference's own
  tolerance for its ``flash_vjp`` gradients (``tests/test_kernels.py``);
  the forward 2e-5;
- remat against no remat, microbatches 4 against 1: the reference's own
  ``test_microbatch_equivalence`` tolerance (2e-3 relative, 2e-5
  absolute on the parameters; 1e-4 on the loss).
"""
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import latest_step as jax_latest_step
from repro.checkpoint import restore_checkpoint as jax_restore
from repro.checkpoint import save_checkpoint as jax_save
from repro.configs import get_arch as jax_arch
from repro.dataio import lm_token_stream as jax_token_stream
from repro.distributed.sharding import REPLICATED as JAX_REPLICATED
from repro.kernels.flash_vjp import flash_attention as jax_flash_vjp
from repro.models import get_model as jax_model
from repro.training import TrainConfig as JaxTrainConfig
from repro.training import make_train_step as jax_make_train_step
from repro.training.optimizer import adamw_update as jax_adamw
from repro.training.optimizer import lr_schedule as jax_lr_schedule
from repro.training.train_step import init_train_state as jax_init_state
from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import ALL_ARCHS, get_arch
from repro_torch.dataio import ShardedLoader, lm_token_stream
from repro_torch.distributed.fault import TrainSupervisor
from repro_torch.distributed.sharding import REPLICATED
from repro_torch.interop import train_state_from_jax
from repro_torch.kernels.flash_vjp import flash_attention
from repro_torch.models import get_model
from repro_torch.models.lm import tree_map
from repro_torch.training import TrainConfig, lr_schedule, make_train_step
from repro_torch.training.optimizer import adamw_update
from repro_torch.training.train_step import init_train_state

torch.set_num_threads(1)

TRAIN_ARCHS = ["qwen3-0.6b", "zamba2-2.7b", "rwkv6-1.6b",
               "granite-moe-1b-a400m", "whisper-small", "internvl2-1b",
               "minicpm-2b"]
ATTN_CASES = [  # tests/test_kernels.py's, B, Sq, Sk, H, Hkv, D, causal
    (2, 128, 128, 4, 2, 32, True),
    (1, 96, 96, 4, 4, 16, True),
    (2, 64, 192, 6, 2, 32, False),
    (1, 100, 100, 2, 1, 64, True),
]


def _by_path(tree) -> dict:
    """{path: float32 np.ndarray} of a JAX or a port tree."""
    out = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(prefix + (k,), v)
        elif isinstance(node, torch.Tensor):
            out[prefix] = node.detach().float().numpy()
        else:
            out[prefix] = np.asarray(node, np.float32)
    walk((), tree)
    return out


def _batch(cfg, batch, seq, step, seed=5):
    """A seeded numpy batch (tokens from the shared token stream; numpy
    frames or patch embeddings where the config takes them)."""
    rng = np.random.default_rng(seed)
    b = {"tokens": jax_token_stream(batch, seq, cfg.vocab_size, step)}
    if cfg.frontend == "vit_stub":
        b["patch_embeds"] = (rng.standard_normal(
            (batch, cfg.num_patches, cfg.d_model)) * 0.1).astype(np.float32)
    if cfg.is_encoder_decoder:
        b["frames"] = (rng.standard_normal(
            (batch, cfg.encoder_seq_len, cfg.d_model)) * 0.1).astype(np.float32)
    return b


def _one_step(arch, *, batch=4, seq=16, **tkw):
    """One train step of the reference (jitted) and of the port from the
    same JAX state -> (jax state, jax metrics, port state, port metrics,
    the starting params by path)."""
    kw = dict(learning_rate=1e-3, total_steps=50, warmup_steps=5,
              remat=True, **tkw)
    jcfg = jax_arch(arch, reduced=True)
    jm = jax_model(jcfg)
    state = jax_init_state(jm, jax.random.PRNGKey(0))
    np_state = jax.tree.map(np.asarray, state)
    b = _batch(jcfg, batch, seq, 0)
    jstate, jmet = jax.jit(jax_make_train_step(jm, JaxTrainConfig(**kw),
                                               JAX_REPLICATED))(
        state, {k: jnp.asarray(v) for k, v in b.items()})
    cfg = get_arch(arch, reduced=True)
    tstate = train_state_from_jax(np_state, cfg, device="cpu")
    step = make_train_step(get_model(cfg), TrainConfig(**kw), REPLICATED)
    tstate, tmet = step(tstate, {k: torch.from_numpy(v) for k, v in b.items()})
    return jstate, jmet, tstate, tmet, _by_path(np_state["params"])


def _metrics_close(jmet, tmet, rtol_loss, rtol_norm):
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=rtol_loss)
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=rtol_norm)
    np.testing.assert_allclose(float(tmet["lr"]), float(jmet["lr"]), rtol=1e-6)
    for k in ("ce", "aux", "ntok"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=rtol_loss, atol=1e-6)


# ------------------------------------------------------------ optimizer
@pytest.mark.parametrize("schedule", ["wsd", "cosine", "linear", "constant"])
def test_lr_schedule_matches_the_reference(schedule):
    kw = dict(learning_rate=3e-3, warmup_steps=10, total_steps=100,
              schedule=schedule)
    want, got = jax_lr_schedule(JaxTrainConfig(**kw)), lr_schedule(
        TrainConfig(**kw))
    for step in (0, 1, 5, 9, 10, 11, 50, 89, 90, 91, 95, 99, 100, 120):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=1e-12)


def test_adamw_update_matches_the_reference_on_1d_2d_and_stacked_leaves():
    """Weight decay on every leaf of two or more dimensions (the stacked
    (L, d) norms included), none on 1-D ones; float32 moments; two steps
    so the bias corrections differ from the first."""
    rng = np.random.default_rng(0)
    shapes = {"bias": (7,), "w": (5, 6), "stack": {"norm": (3, 8),
                                                   "w": (3, 4, 5)}}
    params = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32),
                          shapes, is_leaf=lambda x: isinstance(x, tuple))
    grads = jax.tree.map(lambda p: rng.standard_normal(p.shape)
                         .astype(np.float32), params)
    cfg = dict(weight_decay=0.1)
    jp, jm_, jv = params, *(jax.tree.map(np.zeros_like, params),) * 2
    to_t = lambda t: tree_map(lambda a: torch.from_numpy(np.asarray(a)), t)  # noqa: E731
    tp, tm, tv = to_t(params), to_t(jm_), to_t(jv)
    for step, lr in ((1, 1e-3), (2, 3e-3)):
        jp, jm_, jv = jax_adamw(jp, grads, jm_, jv, step,
                                JaxTrainConfig(**cfg), lr)
        tp, tm, tv = adamw_update(tp, to_t(grads), tm, tv, step,
                                  TrainConfig(**cfg), lr)
    for want, got in ((jp, tp), (jm_, tm), (jv, tv)):
        w, g = _by_path(want), _by_path(got)
        assert set(w) == set(g)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], atol=1e-6, rtol=0)
    assert all(t.dtype == torch.float32 for t in (tm["w"], tv["stack"]["w"]))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_axes_trees_match_the_reference(arch):
    """The logical-axis trees of the parameters, the cache and the train
    state equal the reference's, and cover the port's parameter tree
    leaf for leaf, each with one axis name a dimension."""
    from repro.training.train_step import train_state_axes as jax_axes
    from repro_torch.training.train_step import train_state_axes
    jm, api = jax_model(jax_arch(arch, reduced=True)), get_model(
        get_arch(arch, reduced=True))
    assert api.param_axes() == jm.param_axes()
    assert train_state_axes(api) == jax_axes(jm)
    axes = _leaves_by_path(api.param_axes())
    params = _by_path(api.init(torch.Generator().manual_seed(0)))
    assert set(axes) == set(params)
    assert all(len(axes[k]) == params[k].ndim for k in axes)


def _leaves_by_path(tree, prefix=()):
    if isinstance(tree, dict):
        return {path: leaf for k, v in tree.items()
                for path, leaf in _leaves_by_path(v, prefix + (k,)).items()}
    return {prefix: tree}


# ----------------------------------------------------- one train step
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_one_float32_train_step_matches_the_reference(arch):
    jstate, jmet, tstate, tmet, p0 = _one_step(
        arch, compute_dtype="float32", grad_reduce_dtype="float32")
    _metrics_close(jmet, tmet, 1e-5, 1e-5)
    assert int(tstate["step"]) == int(jstate["step"]) == 1
    lr, b1, eps = float(jmet["lr"]), 0.9, 1e-8
    jm_, tm = _by_path(jstate["m"]), _by_path(tstate["m"])
    for name in ("m", "v"):
        w, g = _by_path(jstate[name]), _by_path(tstate[name])
        top = max(float(np.abs(a).max()) for a in w.values())
        for k in w:
            np.testing.assert_allclose(g[k], w[k], atol=1e-5 * top, rtol=0)
    w, g = _by_path(jstate["params"]), _by_path(tstate["params"])
    assert set(w) == set(g) == set(p0)
    for k in w:
        allowed = lr * (1e-3 + np.abs(tm[k] - jm_[k]) / ((1 - b1) * eps))
        assert np.all(np.abs(g[k] - w[k]) <= allowed + 1e-7), k
        assert float(np.abs(w[k] - p0[k]).max()) > 0.0    # the step moved it


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "minicpm-2b",
                                  "whisper-small"])
def test_one_train_step_at_the_defaults_matches_the_reference(arch):
    """bfloat16 compute and bfloat16 gradient rounding, TrainConfig's
    defaults.  Whisper's float32 frames meet its bfloat16 weights: both
    packages run its encoder in float32 (type promotion)."""
    jstate, jmet, tstate, tmet, p0 = _one_step(arch)
    _metrics_close(jmet, tmet, 1e-3, 1e-2)
    lr = float(jmet["lr"])
    w, g = _by_path(jstate["params"]), _by_path(tstate["params"])
    num = den = far = n = 0.0
    for k in w:
        uw, ug = w[k] - p0[k], g[k] - p0[k]
        num += float(np.square(ug - uw).sum())
        den += float(np.square(uw).sum())
        far += float((np.abs(ug - uw) > 1e-2 * lr).sum())
        n += uw.size
    assert np.sqrt(num / den) <= 0.5 and far / n <= 0.05, (np.sqrt(num / den),
                                                           far / n)


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "rwkv6-1.6b"])
def test_three_launcher_steps_of_the_scan_models_match_the_reference(arch):
    """Three steps from one JAX state at the launchers' settings (lr
    3e-3, warmup 5, float32 compute, bfloat16 gradient rounding, remat;
    the reference's ``launch/train.py``) on the launchers' batches:
    each step's loss within 1e-5 and gradient norm within 1e-4,
    relative, of the reference's (a later step's loss carries every
    earlier update)."""
    from repro.launch.train import make_batch_fn as jax_make_batch_fn
    from repro_torch.launch.train import make_batch_fn
    kw = dict(learning_rate=3e-3, total_steps=3, warmup_steps=5,
              compute_dtype="float32", remat=True)
    jcfg = jax_arch(arch, reduced=True)
    jm = jax_model(jcfg)
    state = jax_init_state(jm, jax.random.PRNGKey(0))
    tstate = train_state_from_jax(jax.tree.map(np.asarray, state),
                                  get_arch(arch, reduced=True), device="cpu")
    jstep = jax.jit(jax_make_train_step(jm, JaxTrainConfig(**kw),
                                        JAX_REPLICATED))
    tstep = make_train_step(get_model(get_arch(arch, reduced=True)),
                            TrainConfig(**kw), REPLICATED)
    jmake = jax_make_batch_fn(jcfg, 4, 32)
    tmake = make_batch_fn(get_arch(arch, reduced=True), 4, 32)
    for i in range(3):
        b, tb = jmake(i), tmake(i)
        for k in b:
            np.testing.assert_array_equal(tb[k], b[k])
        state, jmet = jstep(state, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tmet = tstep(tstate, {k: torch.from_numpy(v)
                                      for k, v in tb.items()})
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=1e-5, err_msg=f"step {i + 1}")
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-4,
                                   err_msg=f"step {i + 1}")


def test_microbatched_train_step_matches_the_reference():
    jstate, jmet, tstate, tmet, _ = _one_step(
        "qwen3-0.6b", batch=8, compute_dtype="float32",
        grad_reduce_dtype="float32", microbatches=4)
    _metrics_close(jmet, tmet, 1e-5, 1e-5)
    w, g = _by_path(jstate["params"]), _by_path(tstate["params"])
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=2e-3, atol=2e-5)


def test_train_step_through_flash_attention_matches_the_reference():
    """Reduced qwen3 at 1,100 tokens: both packages take ``flash_vjp``
    (the port's Function on the CPU) under the gradient."""
    import repro_torch.kernels.flash_vjp as fv
    calls = []
    orig = fv.flash_backward

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)
    fv.flash_backward = spy
    try:
        jstate, jmet, tstate, tmet, _ = _one_step(
            "qwen3-0.6b", batch=1, seq=1100, compute_dtype="float32",
            grad_reduce_dtype="float32")
    finally:
        fv.flash_backward = orig
    assert len(calls) == get_arch("qwen3-0.6b", reduced=True).num_layers
    _metrics_close(jmet, tmet, 1e-5, 1e-5)
    w, g = _by_path(jstate["m"]), _by_path(tstate["m"])
    top = max(float(np.abs(a).max()) for a in w.values())
    for k in w:
        np.testing.assert_allclose(g[k], w[k], atol=1e-5 * top, rtol=0)


def _grads(api, params, batch, remat):
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, _ = api.loss(leaves, batch, REPLICATED, remat=remat)
    flat = []
    tree_map(flat.append, leaves)
    return loss, torch.autograd.grad(loss, flat)


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "whisper-small"])
def test_remat_computes_the_same_loss_and_gradients(arch):
    """The hybrid's remat body is a whole group (shared block and its
    Mamba2 blocks); the encoder-decoder's one encoder or decoder layer."""
    cfg = get_arch(arch, reduced=True)
    api = get_model(cfg)
    params = api.init(torch.Generator().manual_seed(0))
    b = {k: torch.from_numpy(v) for k, v in _batch(cfg, 2, 12, 0).items()}
    l0, g0 = _grads(api, params, b, remat=False)
    l1, g1 = _grads(api, params, b, remat=True)
    np.testing.assert_allclose(float(l1.detach()), float(l0.detach()),
                               rtol=1e-6)
    for a, c in zip(g0, g1):
        torch.testing.assert_close(c, a, rtol=2e-3, atol=2e-5)


# ------------------------------------------------ flash attention's vjp
def _flash_case(B, Sq, Sk, H, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D), (B, Sq, H, D))]


@pytest.mark.parametrize("case", ATTN_CASES + [
    (1, 40, 130, 4, 2, 16, True, 17),     # prefill into a cache at offset 17
    (1, 70, 70, 2, 2, 80, True, 0),       # zamba2's head dim
])
def test_flash_function_gradients_match_the_reference_vjp(case):
    """Blocks of 32 queries and 64 keys, so the backward walks several
    block pairs and skips the key blocks past the causal edge."""
    B, Sq, Sk, H, Hkv, D, causal, *off = case
    q_offset = off[0] if off else 0
    q, k, v, do = _flash_case(B, Sq, Sk, H, Hkv, D, sum(case))
    out, vjp = jax.vjp(lambda a, b, c: jax_flash_vjp(
        a, b, c, q_offset, causal, None, 32, 64), q, k, v)
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = flash_attention(tq, tk, tv, q_offset, causal, None, 32, 64)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               atol=2e-5, rtol=0)
    got.backward(torch.from_numpy(do))
    for w, t in zip(want, (tq, tk, tv)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=2e-4,
                                   rtol=0)


def test_flash_function_keeps_bfloat16_grads_and_needs_no_grad():
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16) for x in
                   _flash_case(1, 64, 64, 2, 1, 16, 3))
    q.requires_grad_()
    out = flash_attention(q, k, v, 0, True, None, 32, 32)
    out.backward(do)
    assert out.dtype == q.grad.dtype == torch.bfloat16
    assert k.grad is None
    with torch.no_grad():
        assert flash_attention(q, k, v).grad_fn is None


# ---------------------------------------------------------- checkpoints
def _reduced_states():
    jcfg = jax_arch("qwen3-0.6b", reduced=True)
    jstate = jax_init_state(jax_model(jcfg), jax.random.PRNGKey(3))
    np_state = jax.tree.map(np.asarray, jstate)
    cfg = get_arch("qwen3-0.6b", reduced=True)
    return jstate, np_state, train_state_from_jax(np_state, cfg, "cpu")


def test_checkpoints_restore_across_the_two_packages():
    jstate, np_state, tstate = _reduced_states()
    tstate["step"].fill_(7)
    with tempfile.TemporaryDirectory() as d:
        jax_save(os.path.join(d, "ref"), 4, jstate)
        got, step = restore_checkpoint(os.path.join(d, "ref"), tstate)
        assert step == 4 and got["step"].dtype == torch.int32
        assert int(got["step"]) == 0
        w, g = _by_path(np_state), _by_path(got)
        assert set(w) == set(g)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
        save_checkpoint(os.path.join(d, "port"), 7, tstate)
        back, step = jax_restore(os.path.join(d, "port"), jstate)
        assert step == 7 and int(back["step"]) == 7
        assert np.asarray(back["step"]).dtype == np.int32
        w = _by_path(tstate)
        for k, v in _by_path(back).items():
            np.testing.assert_array_equal(v, w[k])


def test_checkpoint_gc_tmp_dirs_and_refusals():
    _, _, tstate = _reduced_states()
    with tempfile.TemporaryDirectory() as d:
        for s in (1, 2, 3, 4):
            save_checkpoint(d, s, tstate, keep=2)
        assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004"]
        # a save cut before its manifest: invisible to both packages
        os.makedirs(os.path.join(d, "step_00000009.tmp"))
        os.makedirs(os.path.join(d, "step_00000008"))
        assert latest_step(d) == jax_latest_step(d) == 4
        with pytest.raises(ValueError, match="mismatch"):
            restore_checkpoint(d, {"params": tstate["params"]})
        with pytest.raises(TypeError, match="bfloat16"):
            save_checkpoint(d, 5, {"w": torch.zeros(2, dtype=torch.bfloat16)})
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(os.path.join(d, "gone"), tstate)


# ----------------------------------------------------------- launcher
def test_launcher_trains_and_restarts_from_its_checkpoint():
    from repro_torch.launch import train
    kw = dict(reduced=True, batch=2, seq=16, device="cpu", save_every=3)
    straight = train.run("qwen3-0.6b", steps=5, **kw)
    with tempfile.TemporaryDirectory() as d:
        first = train.run("qwen3-0.6b", steps=3, ckpt_dir=d, **kw)
        assert latest_step(d) == 3 and first["start_step"] == 0
        again = train.run("qwen3-0.6b", steps=5, ckpt_dir=d, **kw)
    assert again["start_step"] == 3 and again["steps"] == 2
    np.testing.assert_allclose(first["losses"] + again["losses"],
                               straight["losses"], rtol=1e-6)
    assert len(straight["step_s"]) == 5


def test_launcher_refusals_name_their_slice():
    """The launcher builds the reference's meshes: ``model_par=2``
    without a process group is clamped to the one rank and trains
    exactly as ``model_par=1`` does; the production mesh raises, naming
    the ranks it needs; the hybrid and rwkv families are no longer
    refused (their scans have a backward on every device), and train
    here as on the card."""
    from repro_torch.launch import train
    kw = dict(reduced=True, steps=2, batch=2, seq=16, device="cpu")
    one = train.run("qwen3-0.6b", model_par=1, **kw)
    two = train.run("qwen3-0.6b", model_par=2, **kw)
    assert one["losses"] == two["losses"]
    assert one["grad_norms"] == two["grad_norms"]
    with pytest.raises(ValueError, match="256 ranks"):
        train.run("qwen3-0.6b", mesh_kind="production", device="cpu")
    with pytest.raises(ValueError, match="512 ranks"):
        from repro_torch.launch.mesh import make_production_mesh
        make_production_mesh(multi_pod=True)
    src = open(train.__file__).read()
    assert "family_kind" not in src and "no backward" not in src
    for arch in ("zamba2-2.7b", "rwkv6-1.6b"):
        r = train.run(arch, **kw)
        assert r["steps"] == 2 and all(np.isfinite(r["losses"]))


def test_loader_prefetches_in_order_and_stops():
    loader = ShardedLoader(lambda s: {"tokens": lm_token_stream(2, 4, 50, s)},
                           start_step=3)
    got = [next(loader) for _ in range(4)]
    loader.stop()
    assert [s for s, _ in got] == [3, 4, 5, 6]
    np.testing.assert_array_equal(got[1][1]["tokens"],
                                  jax_token_stream(2, 4, 50, 4))
    assert not loader._thread.is_alive()


# ------------------------------ tests/test_training.py on the port alone
def _setup(arch="qwen3-0.6b", **tkw):
    cfg = get_arch(arch, reduced=True)
    model = get_model(cfg)
    tcfg = TrainConfig(learning_rate=1e-3, total_steps=50, warmup_steps=5,
                       compute_dtype="float32", remat=False, **tkw)
    step = make_train_step(model, tcfg, REPLICATED)
    state = init_train_state(model, torch.Generator().manual_seed(0))
    return cfg, model, step, state


def _tokens(cfg, step_idx, batch=4, seq=32):
    return {"tokens": torch.from_numpy(
        lm_token_stream(batch, seq, cfg.vocab_size, step_idx))}


def test_loss_decreases():
    cfg, model, step, state = _setup()
    losses = []
    for i in range(25):
        state, m = step(state, _tokens(cfg, i))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses[:3] + losses[-3:]


def test_microbatch_equivalence():
    """mb=1 and mb=4 produce (nearly) identical updates for equal splits."""
    cfg, model, step1, state1 = _setup(microbatches=1)
    _, _, step4, state4 = _setup(microbatches=4)
    b = _tokens(cfg, 0, batch=8)
    s1, m1 = step1(state1, b)
    s4, m4 = step4(state4, b)
    np.testing.assert_allclose(float(m4["loss"]), float(m1["loss"]), rtol=1e-4)
    w, g = _by_path(s1["params"]), _by_path(s4["params"])
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=2e-3, atol=2e-5)


def test_grad_clipping_bounds_update():
    cfg, model, step, state = _setup()
    before = _by_path(state["params"])
    state2, m = step(state, _tokens(cfg, 0))
    lr = float(m["lr"])
    for k, v in _by_path(state2["params"]).items():
        assert float(np.abs(v - before[k]).max()) < 50 * lr


def test_checkpoint_restart_continues_training():
    cfg, model, step, state = _setup()
    with tempfile.TemporaryDirectory() as d:
        sup = TrainSupervisor(d, save_every=5)
        for i in range(7):
            state, m = step(state, _tokens(cfg, i))
            sup.maybe_save(i + 1, state)
        template = init_train_state(model, torch.Generator().manual_seed(0))
        restored, start = sup.resume(template)
        assert start == 5
        assert int(restored["step"]) == 5
        restored, m = step(restored, _tokens(cfg, start))
        assert np.isfinite(float(m["loss"]))


def test_wsd_vs_cosine_schedules_differ_mid_run():
    w = lr_schedule(TrainConfig(learning_rate=1e-3, warmup_steps=10,
                                total_steps=100, schedule="wsd"))
    c = lr_schedule(TrainConfig(learning_rate=1e-3, warmup_steps=10,
                                total_steps=100, schedule="cosine"))
    assert float(w(50)) == pytest.approx(1e-3)
    assert float(c(50)) < 1e-3 * 0.99


def test_encdec_training_step():
    cfg, model, step, state = _setup("whisper-small")
    b = _tokens(cfg, 0, batch=2, seq=16)
    b["frames"] = torch.ones((2, cfg.encoder_seq_len, cfg.d_model)) * 0.01
    state, m = step(state, b)
    assert np.isfinite(float(m["loss"]))
