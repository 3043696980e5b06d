"""Host-side logic of ``chip_smoke.py`` that a host without a card can
check: which kernels ``--ab`` compares by default, the attention mask
behind K3's library time at a cache offset, and a rehearsal of phases 9
and 10 (the scale-out path and the baselines) on the CPU at a few
entities each, where the kernels' launch counts stay 0, phase 18's
two rank processes (gloo on the CPU) at reduced sizes, and phase 23's
float8 cache on reduced qwen1.5-32b.

Tolerance: the masked ``scaled_dot_product_attention`` against the plain
flash forward, 1e-5 absolute (the same float32 softmax over the same
products, as ``tests/test_torch_kernels.py`` holds attention routes);
the phases apply their own (``chip_smoke.PIPE_TOL``, the static hash).
"""
import shutil

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke as cs
from repro_torch.kernels import _build, ref


def _copy_csrc(tmp_path):
    old = tmp_path / "old_csrc"
    shutil.copytree(_build.CSRC, old)
    return old


def test_ab_compares_no_kernel_of_identical_sources(tmp_path):
    assert cs.changed_kernels(_copy_csrc(tmp_path)) == []


@pytest.mark.parametrize("edit,want", [
    ("rwkv6_scan.cu", ["rwkv6_scan"]),
    ("gaussian_blur.cu", ["gaussian_blur"]),
    ("flash_attention_bwd.cu", ["flash_attention_backward"]),
    ("rwkv6_scan_bwd.cu", ["rwkv6_scan_backward"]),
    ("mamba2_ssd_bwd.cu", ["mamba2_ssd_backward"]),
    # the shared header: every kernel that includes it
    ("tc.cuh", ["flash_attention", "flash_attention_backward", "mamba2_ssd",
                "mamba2_ssd_backward", "rwkv6_scan", "rwkv6_scan_backward"]),
    ("preprocess.cu", ["preprocess"]),
])
def test_ab_compares_the_kernels_whose_sources_differ(tmp_path, edit, want):
    import repro_torch.kernels.flash_attention  # noqa: F401  (declares)
    import repro_torch.kernels.gaussian_blur  # noqa: F401
    import repro_torch.kernels.mamba2_ssd  # noqa: F401
    import repro_torch.kernels.preprocess  # noqa: F401
    import repro_torch.kernels.rwkv6_scan  # noqa: F401
    old = _copy_csrc(tmp_path)
    (old / edit).write_text((old / edit).read_text() + "\n// older\n")
    assert sorted(cs.changed_kernels(old)) == want
    (old / edit).unlink()       # a source the old commit lacks differs too
    assert sorted(cs.changed_kernels(old)) == want


@pytest.mark.parametrize("Sq,Sk,q_offset", [(8, 29, 21), (5, 40, 12)])
def test_offset_mask_gives_the_prefill_into_a_cache(Sq, Sk, q_offset):
    rng = np.random.default_rng(Sq + Sk)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, Sq, 4, 16), (2, Sk, 2, 16), (2, Sk, 2, 16)))
    mask = cs.offset_mask(Sq, Sk, q_offset, device="cpu")
    got = F.scaled_dot_product_attention(
        *(t.transpose(1, 2) for t in (q, k, v)), attn_mask=mask,
        enable_gqa=True).transpose(1, 2)
    want, _ = ref.flash_attention_chunked(q, k, v, causal=True,
                                          q_offset=q_offset)
    assert float((got - want).abs().max()) <= 1e-5


def _engine_path_launches():
    from repro_torch.kernels import gaussian_blur as gb
    from repro_torch.kernels import preprocess as pp
    return {"gaussian_blur": gb.launches,
            "fused_resize_crop_normalize": pp.launches}


def test_phase_9_rehearsed_on_the_cpu():
    from repro_torch.core.engine import VDMSAsyncEngine
    from repro_torch.core.remote import TransportModel
    from repro_torch.dataio.synthetic import synthetic_faces
    launches = _engine_path_launches()
    faces = synthetic_faces(10, 250, seed=1)
    phase4 = cs.phase_device(VDMSAsyncEngine, TransportModel, faces,
                             launches, device="cpu")
    before = {k: c.count for k, c in launches.items()}
    hashes = cs.phase_wire_hash(device="cpu")
    assert sorted(hashes) == ["cluster_1_shard", "wire", "wire_cluster"]
    assert {h["sha256"] for h in hashes.values()} == {cs.STATIC_SHA256}
    out = cs.phase_cluster_chain(faces, phase4.pop("response"), launches,
                                 device="cpu")
    assert sum(out["shards_4"]["owned_primary"].values()) == len(faces)
    assert out["wire"]["max_abs_err_vs_phase4"] == 0.0
    assert out["kill"]["failovers"].get(1, 0) >= 1
    assert 1 not in out["kill"]["live_shards"]
    assert {k: c.count for k, c in launches.items()} == before


REMOTE_BLUR = {"type": "remote", "url": "u",
               "options": {"id": "blur", "ksize": 5, "sigma_x": 1.5}}


def test_phase_10_rehearsed_on_the_cpu():
    result = cs.phase_baselines("cpu", sizes=dict(
        c1=dict(n_images=2, queries={"IQ3_blur": [REMOTE_BLUR]}),
        c2=dict(n_images=2), c3=dict(n_images=2, clients=(2,)),
        shards=dict(shard_counts=(1, 2), n_images=6, repeats=1),
        kappa=dict(kappas=(1, 2), n_images=4)))
    assert [r["name"] for r in result["c1"]] == ["image_c1_IQ3_blur"]
    for row in result["c1"] + result["c2"]:
        assert max(row["max_abs_err"].values()) == 0.0
    assert [r["shards"] for r in result["shards"]] == [1, 2]
    assert result["shards"][0]["gain"] == 1.0
    assert [r["name"] for r in result["kappa"]] == ["scaleout_k1",
                                                    "scaleout_k2"]


def test_phase_16_rehearsed_on_the_cpu():
    """Phase 16 on reduced configs: zamba2 cut to 2 hybrid groups, host
    against host (the card's copy is a CPU copy), both families through
    ``launch.train.run``, every leaf's gradient of rwkv6 cut to 2 layers
    finite and not all zero, and rwkv6 cut to 2 layers host against
    host."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_ssd, rwkv6_scan
    launches = {"flash_attention": fa.launches,
                "mamba2_ssd": mamba2_ssd.launches,
                "rwkv6_scan": rwkv6_scan.launches}
    out = cs.phase_scan_training(launches, device="cpu", reduced=True,
                                 seq=40, host_seq=24)
    assert out["card_vs_host"]["loss_rel"] == 0.0
    assert out["card_vs_host"]["grad_norm_rel"] == 0.0
    assert out["rwkv6_card_vs_host"]["loss_rel"] == 0.0
    assert out["rwkv6_card_vs_host"]["grad_norm_rel"] == 0.0
    assert len(out["zamba2"]["losses"]) == len(out["rwkv6"]["losses"]) == 2
    norms = out["rwkv6_leaves"]["leaf_grad_norms"]
    assert all(0.0 < v < float("inf") for v in norms.values())
    assert any(k.endswith("/u") for k in norms)


def test_phase_17_rehearsed_on_the_cpu():
    """Phase 17 through a one-rank gloo group in place of NCCL: the
    clamp, the int8 mean and error feedback against numpy (exact on the
    CPU), remesh onto the one-rank mesh; the group is destroyed."""
    out = cs.phase_distribution(device="cpu")
    assert out["psum_err"] == 0.0 and out["error_feedback_err"] == 0.0
    assert out["backend"] == "gloo" and out["remeshed_leaves"] > 0
    assert not torch.distributed.is_initialized()
    losses = out["train_model_par"]["losses"]
    assert losses[0] == losses[1]


def test_phase_15_rehearsed_on_the_cpu():
    """Phase 15's four parts on reduced configs: card-against-host
    becomes host against host, the resumed run must match the straight
    one, and the bfloat16 step must differ from the float32 one (it
    computes in another precision) within the stated tolerances."""
    from repro_torch.kernels import flash_attention as fa
    out = cs.phase_training({"flash_attention": fa.launches}, device="cpu",
                            reduced=True, seq=24)
    assert out["card_vs_host"]["loss_rel"] == 0.0
    assert out["qwen3_resumed"]["start_step"] == 2
    assert out["qwen3_resume_loss_rel"] <= cs.TRAIN_LOSS_RTOL
    assert len(out["minicpm"]["losses"]) == 2
    bf16 = out["minicpm_bf16_vs_f32"]
    assert 0.0 < bf16["m_rel_l2"] <= cs.TRAIN_BF16_M_RTOL
    assert 0.0 < bf16["embed_m_rel_l2"] <= cs.TRAIN_BF16_EMBED_M_RTOL


def test_phase_18_rehearsed_on_the_cpu(tmp_path, monkeypatch):
    """Phase 18's two rank processes on the CPU at the reduced sizes:
    every run at model_par=2 matches its model_par=1 run (the phase's
    own checks), the EP route runs, and the parameter bytes equal the
    spec arithmetic's."""
    monkeypatch.setattr(cs, "ROOT", str(tmp_path))
    out = cs.phase_tensor_parallel(device="cpu", reduced=True)
    runs = [r["name"] for r in cs.tp_runs(reduced=True)]
    assert sorted(out["runs"]) == sorted(runs)
    for name in runs:
        for r in range(cs.TP_RANKS):
            info = out["runs"][name][f"rank_{r}"]
            assert info.get("logits_ok", info.get("train_ok")), (name, info)
    cache = out["runs"]["qwen3_serve"]["rank_0"]["cache"]["k"]
    assert cache[1][2] * 2 == cache[0][2]          # split by slots
    cache = out["runs"]["zamba2_heads_prefill"]["rank_1"]["cache"]["k"]
    assert cache[1][3] * 2 == cache[0][3]          # split by heads


def test_phase_19_rehearsed_on_the_cpu():
    """Phase 19 on reduced configs and short sequences: the production
    cells of 19a at full width under fake groups (in their subprocess),
    and each 19b cell's dry run against the same program run on the CPU
    from a seeded init: the inputs have the dry run's shapes, dtypes and
    bytes (launches and memory are the card's and are not compared)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_ssd, rwkv6_scan
    launches = {"flash_attention": fa.launches,
                "mamba2_ssd": mamba2_ssd.launches,
                "rwkv6_scan": rwkv6_scan.launches}
    cells = [(cs.LONG_ARCH, "train_4k", 2, 48, "flash_attention"),
             (cs.RWKV_ARCH, "prefill_32k", 2, 48, "rwkv6_scan")]
    out = cs.phase_dryrun(launches, device="cpu", reduced=True, cells=cells)
    assert [r["shape"] for r in out["cells"]] == ["train_2x48",
                                                  "prefill_2x48"]
    rwkv = out["cells"][1]
    assert rwkv["predicted_launches"] == {"rwkv6_scan": 2}
    assert all(r["flops"] > 0 and r["wall_s"] > 0 for r in out["cells"])
    assert 0.9 < out["cells"][0]["flops"] / out["cells"][0][
        "train_step_products"] < 1.2
    assert [(r["chips"], r["mesh"]) for r in out["production"]] == [
        (256, "16x16"), (512, "2x16x16")]
    assert not torch.distributed.is_initialized()


def test_phase_20_rehearsed_on_the_cpu():
    """Phase 20 on the CPU at 8 faces: the admission hash, cost against
    static, the fused and per-op chains, the kill and the storm, and the
    cancelled sessions (the launch counts and memory stay 0 here)."""
    from repro_torch.core.engine import VDMSAsyncEngine
    from repro_torch.core.remote import TransportModel
    from repro_torch.dataio.synthetic import synthetic_faces
    launches = _engine_path_launches()
    out = cs.phase_engine_behaviours(
        VDMSAsyncEngine, TransportModel, synthetic_faces(8, 250, seed=0),
        launches, device="cpu")
    assert out["admission_sha256"] == cs.ADMISSION_SHA256
    assert out["fusion"]["fused"]["fused_segments"] > 0
    assert out["fusion"]["per op"]["fused_segments"] == 0
    assert out["storm"]["retried"] > 0
    assert set(out["walls_s"]) == {"20a", "20b", "20c", "20d", "20e"}


def test_phase_21_rehearsed_on_the_cpu():
    """Phase 21 on the CPU: every port bench with its gates, the video
    suite at 2 clips × 3 frames and its real-size run at 1 × 2 × 40 × 56;
    the two gates read off wall clocks are the card's (``timing_gates``),
    and no payload is written (``report``)."""
    small = dict(n_videos=2, frames=3)
    video = {"c1": small, "c2": small, "c3": dict(small, clients=(2,)),
             "cputrace": small,
             "real": dict(n_videos=1, frames=2, size=(40, 56))}
    out = cs.phase_benches(device="cpu", smi="cpu", video=video,
                           timing_gates=False, report=False)
    assert set(out["walls_s"]) == {"dispatch", "admission", "resilience",
                                   "hotpath", "frontend", "serving",
                                   "video"}
    hash_row = out["dispatch"][-1]
    assert hash_row["static_response_sha256"] == cs.STATIC_SHA256
    assert out["admission"][1]["none_response_sha256"] == \
        cs.ADMISSION_SHA256
    names = [r["name"] for r in out["video"]]
    assert "video_c1_VQ3_blur_40x56" in names and \
        "cputrace_vdms_async" in names


def test_phase_22_rehearsed_on_the_cpu():
    """Phase 22 on the CPU: the four examples at small sizes (the
    quickstart at 8 faces, the reduced qwen3 behind the serving example,
    train_lm reduced at 2 x 16 for 2 steps, then a rerun to 3; kappa 1
    and 2 over 8 images), then the roofline suite over phase 19's
    records, rehearsed as in the phase 19 test."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_ssd, rwkv6_scan
    sizes = {"quickstart": ["--faces", "8"],
             "serve": ["--clips", "3", "--frames", "2", "--size", "32",
                       "--warm-sessions", "2", "--steps", "2"],
             "train": {"args": ["--batch", "2", "--seq", "16",
                                "--save-every", "2"],
                       "steps": 2, "resume_steps": 3},
             "scaleout": ["--kappas", "1", "2", "--images", "8",
                          "--clients", "2"]}
    out = cs.phase_examples(device="cpu", sizes=sizes)
    assert out["serve"]["warm_hits"] == 2 * 3
    assert out["train"]["checkpoints"] == ["step_00000002"]
    assert len(out["train"]["resumed_losses"]) == 1
    assert [r["name"] for r in out["scaleout"]] == ["scaleout_k1",
                                                   "scaleout_k2"]
    launches = {"flash_attention": fa.launches,
                "mamba2_ssd": mamba2_ssd.launches,
                "rwkv6_scan": rwkv6_scan.launches}
    cells = [(cs.LONG_ARCH, "train_4k", 2, 48, "flash_attention"),
             (cs.RWKV_ARCH, "prefill_32k", 2, 48, "rwkv6_scan")]
    dry = cs.phase_dryrun(launches, device="cpu", reduced=True, cells=cells)
    roof = cs.phase_roofline(dry)
    assert [(r["arch"], r["mesh"]) for r in roof["rows"]] == [
        ("whisper-small", "16x16"), ("rwkv6-1.6b", "2x16x16")]
    assert set(roof["tables"]) == {"16x16", "2x16x16"}
    assert roof["summary"].count("1 ran OK") == 2
    assert [r["name"] for r in roof["run"]] == [
        "roofline_whisper-small_decode_32k"]
    for row in roof["cells"]:
        assert row["wall_s"] > 0 and row["analytic_flops"] > 0
        assert row["counted_s"]["collective"] == 0     # one rank
        assert row["analytic_s"]["collective"] > 0     # TP all-reduces


def test_phase_23_rehearsed_on_the_cpu():
    """Phase 23 on reduced qwen1.5-32b: 2 x 16 prompt tokens into 21
    slots with a bfloat16 and a float8 cache, one decode step each, 3
    greedy steps on the float8 one (K3 launches stay 0 here: the CPU
    takes the plain routes)."""
    from repro_torch.kernels import flash_attention as fa
    out = cs.phase_f8_cache({"flash_attention": fa.launches}, smi="cpu",
                            device="cpu", reduced=True,
                            run=dict(prompt=16, greedy=3))
    assert out["slots"] == 21 and out["layers"] == 2
    assert out["f8"]["cache_bytes"] * 2 == out["bf16"]["cache_bytes"]
    assert out["f8"]["cache_dtype"] == "torch.float8_e4m3fn"
    assert out["f8"]["k3_operands"] == out["bf16"]["k3_operands"] == \
        "torch.float32"
    assert out["f8_vs_bf16"]["max_abs_diff"] < cs.F8_MAX_DIFF
    assert out["f8_card_vs_host"]["max_abs_diff"] == 0.0   # both the CPU
    assert len(out["greedy"]["tokens"]) == 2
    assert len(out["greedy"]["tokens"][0]) == 3


@pytest.mark.parametrize("wrong", [False, True])
def test_held_calls_hold_every_shape_against_the_plain_version(monkeypatch,
                                                                wrong):
    """``HeldCalls`` sees every call of K1's and K2's wrappers made
    through ``kernels.ops`` and holds the first at each shape and window
    against the plain version on its own input: a stand-in for the
    kernel that is wrong only at one batch of 8 fails there.  On the CPU
    the engine never reaches the wrappers, so the stand-ins are called
    directly."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import preprocess as pp

    def blur(img, ksize, sigma_x, sigma_y=None):
        out = ref.gaussian_blur_ref(img, ksize, sigma_x, sigma_y)
        return out + 1e-6 if wrong and img.shape[0] == 8 else out

    monkeypatch.setattr(ops, "gaussian_blur_cuda", blur)
    monkeypatch.setattr(pp, "fused_resize_crop_normalize_cuda",
                        pp.fused_resize_crop_normalize_ref)
    rng = np.random.default_rng(0)
    x1, x8 = (torch.from_numpy(rng.uniform(0, 1, s).astype(np.float32))
              for s in ((1, 20, 24, 3), (8, 72, 72, 3)))
    with cs.HeldCalls() as held:
        for _ in range(3):
            ops.gaussian_blur(x1, 5, 1.5)   # the plain path: not held
            ops.gaussian_blur_cuda(x1, 5, 1.5, None)
        ops.gaussian_blur_cuda(x8, 7, 2.0, None)
        pp.fused_resize_crop_normalize_cuda(x8, **cs.K2_FUSED_ARM)
    assert ops.gaussian_blur_cuda is blur
    assert held.launches("K1") == 4 and held.launches("K2") == 1
    counts = {"gaussian_blur": 4, "fused_resize_crop_normalize": 1}
    if wrong:
        with pytest.raises(cs.SmokeFailure, match=r"K1 \(8, 72, 72, 3\)"):
            cs.check_held(held, 21, counts)
        return
    rows = cs.check_held(held, 21, counts)
    assert sorted((r["kernel"], tuple(r["shape"]), r["calls"])
                  for r in rows) == [("K1", (1, 20, 24, 3), 3),
                                     ("K1", (8, 72, 72, 3), 1),
                                     ("K2", (8, 72, 72, 3), 1)]
    with pytest.raises(cs.SmokeFailure, match="launches all held"):
        cs.check_held(held, 21, dict(counts, gaussian_blur=5))
