"""The port's multi-pod dry run (``repro_torch.launch.dryrun``) against
the JAX package's own (``repro.launch.dryrun``).

Two subprocesses run at once.  The reference's forces its 512 host
devices (importing ``repro.launch.dryrun`` does) and builds ``Auto``
meshes: ``jax.make_mesh`` on JAX 0.9 makes ``Explicit`` axes, on which
its sharding constraints raise, so its production-mesh tests fail in
the JAX package; on ``Auto`` meshes its cells compile.  The port's runs
under ``fake`` process groups of 256 and 512 ranks.  Held against each
other:

- (a) the port's counterparts of the reference's two production-mesh
  tests (``tests/test_distributed.py``): whisper-small ``decode_32k`` on
  16 x 16 and rwkv6-1.6b ``decode_32k`` on 2 x 16 x 16;
- (b) the exact per-device input bytes of a train, a prefill and a
  decode cell of each family (dense qwen3-0.6b, vlm internvl2-1b,
  hybrid zamba2-2.7b, ssm rwkv6-1.6b, moe granite-moe-1b-a400m, audio
  whisper-small) on both meshes;
- (c) the FLOPs of those decode cells, within 1%: decode runs no kernel
  in either package.  Three families partition their decode step
  another way than GSPMD partitions the reference's, and the tests take
  that difference out exactly, by formula, before the 1% comparison:
  rwkv6 runs its token-shift LoRAs replicated on every model rank,
  where GSPMD splits their contraction over the 16 (so the port does
  the LoRAs' products 16 times over); the MoE at its default rules
  gathers the experts over the data axis and routes its 8 local tokens
  through all 32 (8 slots each, the capacity's floor), where GSPMD
  keeps 2 experts a data rank and routes the global batch's 128 tokens
  (40 slots each); whisper's 12 heads do not divide the 16 model ranks,
  so its cross-attention attends every head on every rank, where GSPMD
  attends gcd(12, 16) = 4 groups of 3.  The raw ratio of each of these
  cells is also held to the one ``PERF.md`` records, so a fault of
  another kind cannot hide behind a formula;
- (d) the FLOPs of reduced dense, MoE and encoder-decoder cells on a
  (1, 1) mesh at 128 and 256 positions, where both packages take plain
  attention, within 2% of ``build_cell`` + ``analyze_hlo``;
- (e) the cells each package skips, and why.
"""
import json
import math
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ["qwen3-0.6b", "internvl2-1b", "zamba2-2.7b", "rwkv6-1.6b",
            "granite-moe-1b-a400m", "whisper-small"]
KINDS = {"train": "train_4k", "prefill": "prefill_32k",
         "decode": "decode_32k"}
MESHES = {False: "16x16", True: "2x16x16"}
REDUCED = ["qwen3-0.6b", "granite-moe-1b-a400m", "whisper-small"]
REDUCED_SHAPES = {"train": (128, 2), "prefill": (256, 2), "decode": (256, 2)}
TIMEOUT_S = 240

_COMMON = f"""
import json, sys
FAMILIES = {FAMILIES!r}
SHAPE_NAMES = {list(KINDS.values())!r}
REDUCED = {REDUCED!r}
REDUCED_SHAPES = {REDUCED_SHAPES!r}
out = {{"bytes": {{}}, "decode": {{}}, "reduced": {{}}, "skips": {{}}}}
"""

_REFERENCE = _COMMON + """
from repro.launch import dryrun, hlo_costs   # forces 512 host devices
import jax
from jax.sharding import AxisType
from repro.configs import ALL_ARCHS, SHAPES, get_arch
from repro.configs.base import ShapeConfig

def auto_mesh(shape, axes, n):
    return jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes),
                         devices=jax.devices()[:n])

for mp, name in ((False, "16x16"), (True, "2x16x16")):
    mesh = (auto_mesh((2, 16, 16), ("pod", "data", "model"), 512) if mp
            else auto_mesh((16, 16), ("data", "model"), 256))
    for arch in FAMILIES:
        for shape in SHAPE_NAMES:
            _, args, in_sh, _, _ = dryrun.build_cell(get_arch(arch),
                                                     SHAPES[shape], mesh)
            out["bytes"][f"{arch}/{shape}/{name}"] = dryrun._sharded_bytes(
                args, in_sh)
        rec = dryrun.run_cell(arch, "decode_32k", multi_pod=mp, mesh=mesh,
                              verbose=False)
        out["decode"][f"{arch}/{name}"] = [rec["status"],
                                           rec.get("flops_per_device")]
one = auto_mesh((1, 1), ("data", "model"), 1)
for arch in REDUCED:
    cfg = get_arch(arch, reduced=True)
    for kind, (S, B) in REDUCED_SHAPES.items():
        fn, args, in_sh, out_sh, donate = dryrun.build_cell(
            cfg, ShapeConfig(kind, S, B, kind), one)
        with one:
            hlo = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh,
                          donate_argnums=donate).lower(*args).compile()
        out["reduced"][f"{arch}/{kind}"] = hlo_costs.analyze_hlo(
            hlo.as_text()).flops
for arch in ALL_ARCHS:
    for shape in SHAPES:
        out["skips"][f"{arch}/{shape}"] = list(
            get_arch(arch).supports_shape(SHAPES[shape]))
print("RESULT " + json.dumps(out))
"""

_PORT = _COMMON + """
from repro_torch.configs import ALL_ARCHS, SHAPES, get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed.sharding import Mesh
from repro_torch.launch import costs, dryrun
from repro_torch.launch.mesh import make_production_mesh

for mp, name in ((False, "16x16"), (True, "2x16x16")):
    with dryrun.fake_group(512 if mp else 256):
        mesh = make_production_mesh(multi_pod=mp)
        for arch in FAMILIES:
            for shape in SHAPE_NAMES:
                _, args = dryrun.build_cell(get_arch(arch), SHAPES[shape],
                                            mesh)
                out["bytes"][f"{arch}/{shape}/{name}"] = costs.nbytes(args)
            # the production mesh from run_cell itself, as the
            # reference's tests call it
            rec = dryrun.run_cell(arch, "decode_32k", multi_pod=mp,
                                  verbose=False)
            rec.pop("traceback", None)
            out["decode"][f"{arch}/{name}"] = rec
one = Mesh(("data", "model"), (1, 1))
for arch in REDUCED:
    cfg = get_arch(arch, reduced=True)
    for kind, (S, B) in REDUCED_SHAPES.items():
        rec = dryrun.run_cell(cfg, ShapeConfig(kind, S, B, kind),
                              multi_pod=False, mesh=one, verbose=False)
        out["reduced"][f"{arch}/{kind}"] = [rec["status"],
                                            rec.get("flops_per_device")]
for arch in ALL_ARCHS:
    for shape in SHAPES:
        out["skips"][f"{arch}/{shape}"] = list(
            get_arch(arch).supports_shape(SHAPES[shape]))
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def results():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", PYTHONWARNINGS="ignore")
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", code], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
        for name, code in (("ref", _REFERENCE), ("port", _PORT))}
    out = {}
    for name, p in procs.items():
        try:
            stdout, stderr = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
            raise
        assert p.returncode == 0, f"{name}: {stderr[-3000:]}"
        line = [ln for ln in stdout.splitlines() if ln.startswith("RESULT ")]
        out[name] = json.loads(line[-1][len("RESULT "):])
    return out


@pytest.mark.parametrize("arch,mp,chips", [("whisper-small", False, 256),
                                           ("rwkv6-1.6b", True, 512)])
def test_port_dryrun_cell_on_production_mesh(results, arch, mp, chips):
    rec = results["port"]["decode"][f"{arch}/{MESHES[mp]}"]
    assert rec["status"] == "ok", rec
    assert rec["chips"] == chips and rec["mesh"] == MESHES[mp]
    assert rec["collective_bytes_per_device"] >= 0
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert rec["kernel_breakdown"] == {}     # decode runs no kernel


@pytest.mark.parametrize("mp", [False, True])
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("arch", FAMILIES)
def test_input_bytes_per_device_equal_the_reference(results, arch, kind, mp):
    key = f"{arch}/{KINDS[kind]}/{MESHES[mp]}"
    assert results["port"]["bytes"][key] == results["ref"]["bytes"][key]
    if kind == "decode":
        rec = results["port"]["decode"][f"{arch}/{MESHES[mp]}"]
        assert rec["input_bytes_per_device"] == results["ref"]["bytes"][key]


# port / reference decode FLOPs of the cells whose partition departs
# from GSPMD's, as PERF.md section 6 records them, per mesh
RAW_RATIO = {("rwkv6-1.6b", False): 1.2250, ("rwkv6-1.6b", True): 1.2250,
             ("granite-moe-1b-a400m", False): 1.3904,
             ("granite-moe-1b-a400m", True): 1.6632,
             ("whisper-small", False): 1.3886,
             ("whisper-small", True): 1.3886}


def _partition_departure(arch, mp) -> int:
    """The decode step's FLOPs a rank of the port does beyond the
    reference's partition (see the module docstring): rwkv6's LoRAs
    (2 b d (10 L + 2 Dl) a layer over its b rows) on all 16 model
    ranks, against 1/16 of them; the MoE's expert FFN (6 C d f/16 an
    expert a layer) over all E experts at the capacity of its b tokens,
    against E/16 experts at the capacity of the global batch; whisper's
    cross-attention (4 S_enc D a head and row a layer: the logits and
    their product with the values) over all H heads, against H/g with
    g = gcd(H, 16)."""
    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.models.moe import capacity
    cfg, B = get_arch(arch), SHAPES["decode_32k"].global_batch
    tp, dp = 16, 32 if mp else 16
    b = B // dp
    if arch == "rwkv6-1.6b":
        lora = 2 * b * cfg.d_model * (10 * cfg.rwkv_mix_lora
                                      + 2 * cfg.rwkv_decay_lora)
        return cfg.num_layers * lora * (tp - 1) // tp
    if arch == "granite-moe-1b-a400m":
        E, expert = cfg.num_experts, 6 * cfg.d_model * cfg.d_ff // tp
        return cfg.num_layers * expert * (E * capacity(cfg, b)
                                          - E // 16 * capacity(cfg, B))
    if arch == "whisper-small":
        H = cfg.num_heads
        head = 4 * b * cfg.encoder_seq_len * cfg.resolved_head_dim
        return cfg.num_layers * head * (H - H // math.gcd(H, tp))
    return 0


@pytest.mark.parametrize("mp", [False, True])
@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_flops_within_one_percent_of_the_reference(results, arch, mp):
    key = f"{arch}/{MESHES[mp]}"
    status, want = results["ref"]["decode"][key]
    assert status == "ok"
    got = results["port"]["decode"][key]["flops_per_device"]
    extra = _partition_departure(arch, mp)
    assert got - extra == pytest.approx(want, rel=0.01)
    assert got / want == pytest.approx(RAW_RATIO.get((arch, mp), 1.0),
                                       abs=1e-3)


@pytest.mark.parametrize("kind", list(REDUCED_SHAPES))
@pytest.mark.parametrize("arch", REDUCED)
def test_plain_attention_cells_flops_within_two_percent(results, arch, kind):
    status, got = results["port"]["reduced"][f"{arch}/{kind}"]
    assert status == "ok"
    want = results["ref"]["reduced"][f"{arch}/{kind}"]
    assert got == pytest.approx(want, rel=0.02)


def test_skipped_cells_are_the_reference_s(results):
    port, ref = results["port"]["skips"], results["ref"]["skips"]
    assert port == ref
    assert sum(not ok for ok, _ in port.values()) == 8
