"""ZeRO-3 in the port's train step: under granite-8b's
``train_sharding_overrides`` (``embed`` on ``data``) every weight is
split over both mesh axes, and the step gathers the ``embed`` dims over
``data`` for the step and reduce-scatters their gradients.  Reduced
granite-8b on a (2, 2) mesh of 4 CPU ``gloo`` ranks, one step from the
reference's initial state, is held against the reference's one-device
step and its step on the same mesh (``Auto`` axes: the reference fails
only on ``Explicit`` ones; 8 forced host devices) with the checks (and
tolerances) of ``tests/test_torch_tensor_parallel.py``: loss, gradient
norm, and each rank's shard of both moments against the spec's slice
and against the block of the device at its mesh coordinates; the
replicated leaves equal across ranks.
The same step on a (2, 2, 2) ``pod`` x ``data`` x ``model`` mesh of 8
ranks (the production multi-pod layout, cut to two ranks an axis)
runs the two gradient paths a pod axis beside a model axis takes: the
batch group of each model index (the pod x data ranks that share it),
over which the replicated leaves' gradients are summed, and the sum over
``pod`` alone of the leaves that ``data`` splits (their gather over
``data`` summed them there).
"""
import numpy as np
import pytest

from test_torch_distributed_ranks import _ranks
from test_torch_tensor_parallel import (LOSS_RTOL, MOMENT_TOL, NORM_RTOL,
                                        TCFG, _common, _spec_slice,
                                        check_mesh_forward, check_mesh_greedy,
                                        check_mesh_shards,
                                        check_mesh_train_step,
                                        reference_outputs, run_families)

NAME, N, MESH = "granite-8b", 4, (2, 2)
POD_MESH, POD_AXES = (2, 2, 2), ("pod", "data", "model")

_ZERO3 = f"""
cfg = config({NAME!r}, get_arch)
api = get_model(cfg)
ref = np.load(os.path.join(REF, {NAME!r} + ".npz"))
rules = dict(default_rules(), **cfg.train_sharding_overrides)
zsh = ShardingCtx(mesh=mesh, rules=rules)
state = train_state_from_jax(unflat(ref, "s"), cfg, "cpu", mesh, rules)
# the step updates the state in place: the shards it starts from, copied
res = {{k: v.copy() for k, v in flat(state["params"], "p0").items()}}
step = make_train_step(api, TrainConfig(**TCFG), zsh)
tb = {{k: torch.from_numpy(v) for k, v in unflat(ref, "tb").items()}}
state, met = step(state, tb)
res.update(loss=float(met["loss"]), gnorm=float(met["grad_norm"]))
for kind in ("params", "m", "v"):
    res.update(flat(state[kind], kind))
np.savez(os.path.join(out, f"zero3_{{rank}}.npz"), **res)
"""

# the same step on the pod x data x model mesh
_POD = """
from repro_torch.configs import get_arch
from repro_torch.distributed.sharding import ShardingCtx, default_rules
from repro_torch.interop import train_state_from_jax
from repro_torch.launch.mesh import _mesh
from repro_torch.models import get_model
from repro_torch.training import TrainConfig, make_train_step
mesh = _mesh(POD_MESH, POD_AXES)
""" + _ZERO3


def _train_specs(shape=MESH, axes=("data", "model")):
    """{params path: spec} under the train overrides on the mesh."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed.sharding import (Mesh, default_rules,
                                                  tree_to_specs)
    from repro_torch.models import get_model
    from repro_torch.models.registry import param_shapes
    cfg = get_arch(NAME, reduced=True)
    api = get_model(cfg)
    rules = dict(default_rules(), **cfg.train_sharding_overrides)
    specs = tree_to_specs(param_shapes(api), api.param_axes(),
                          Mesh(axes, shape), rules)
    out = {}

    def walk(p, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(p + "/" + k, v)
        else:
            out[p] = node
    walk("", specs)
    return out


def _coords(rank, shape, axes):
    """The rank's index on each axis of a row-major mesh."""
    out = {}
    for a, n in zip(reversed(axes), reversed(shape)):
        out[a], rank = rank % n, rank // n
    return out


@pytest.fixture(scope="module")
def ref_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("zero3_ref")
    reference_outputs(d, [NAME], devices=8,
                      meshes=[(NAME, MESH, "body"), (NAME, MESH, "zero3"),
                              (NAME, POD_MESH, "zero3")])
    return d


@pytest.fixture(scope="module")
def outputs(tmp_path_factory, ref_dir):
    tmp = tmp_path_factory.mktemp("zero3_ranks")
    run_families(tmp, ref_dir, [NAME], N, MESH, extra=_ZERO3)
    ref = np.load(ref_dir / f"{NAME}.npz")
    return ref, [np.load(tmp / f"zero3_{r}.npz") for r in range(N)], tmp


@pytest.fixture(scope="module")
def pod_outputs(tmp_path_factory, ref_dir):
    tmp = tmp_path_factory.mktemp("zero3_pod_ranks")
    n = int(np.prod(POD_MESH))
    body = (_common() + f"\nREF = {str(ref_dir)!r}\nTCFG = {TCFG!r}"
            f"\nPOD_MESH = {POD_MESH!r}\nPOD_AXES = {POD_AXES!r}\n"
            + _POD)
    _ranks(tmp, n, body, timeout=240)
    ref = np.load(ref_dir / f"{NAME}.npz")
    return ref, [np.load(tmp / f"zero3_{r}.npz") for r in range(n)], tmp


def test_zero3_splits_every_weight_over_data(outputs):
    specs = _train_specs()
    matrices = [p for p in specs if p.endswith(("/wq", "/w_up", "/wo"))]
    assert matrices
    for path in matrices:
        names = {a for e in specs[path] if e
                 for a in ((e,) if isinstance(e, str) else e)}
        assert names == {"data", "model"}, (path, specs[path])


def _check_step(ref, outs, shape, axes):
    specs = _train_specs(shape, axes)
    sizes = dict(zip(axes, shape))
    for r, got in enumerate(outs):
        np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]),
                                   rtol=LOSS_RTOL, err_msg=f"rank {r}")
        np.testing.assert_allclose(float(got["gnorm"]), float(ref["gnorm"]),
                                   rtol=NORM_RTOL, err_msg=f"rank {r}")
        coords = _coords(r, shape, axes)
        for kind, ref_kind in (("m", "m1"), ("v", "v1")):
            for path, spec in specs.items():
                want = _spec_slice(ref[ref_kind + path], spec, coords, sizes)
                tol = MOMENT_TOL * max(
                    float(np.abs(ref[ref_kind + path]).max()), 1e-30)
                np.testing.assert_allclose(got[kind + path], want, atol=tol,
                                           rtol=0,
                                           err_msg=f"{kind}{path} rank {r}")
    replicated = [p for p, spec in specs.items() if not any(spec)]
    assert replicated
    for path in replicated:
        for r in range(1, len(outs)):
            np.testing.assert_array_equal(outs[r]["params" + path],
                                          outs[0]["params" + path],
                                          err_msg=f"{path}: rank {r}")
    return specs


def test_zero3_step_matches_the_reference(outputs):
    _check_step(*outputs[:2], MESH, ("data", "model"))


def test_zero3_step_on_a_pod_data_model_mesh_matches_the_reference(
        pod_outputs):
    specs = _check_step(*pod_outputs[:2], POD_MESH, POD_AXES)
    # the step took both pod paths: leaves split over data and not pod,
    # and leaves split over neither batch axis
    names = {p: {a for e in spec if e
                 for a in ((e,) if isinstance(e, str) else e)}
             for p, spec in specs.items()}
    assert any("data" in n and "pod" not in n for n in names.values())
    assert any(not n & {"pod", "data"} for n in names.values())


# the port's ZeRO-3 state carries the step's new parameters and moments
# as "params", "m" and "v"
ZERO3_KEYS = {"p1": "params", "m1": "m", "v1": "v"}


@pytest.mark.parametrize("shape", [MESH, POD_MESH], ids=["2x2", "2x2x2"])
def test_zero3_step_matches_the_mesh_program(ref_dir, outputs, pod_outputs,
                                             shape):
    """The step under the ``train_sharding_overrides`` against the JAX
    package's step on an ``Auto`` mesh of the same shape: loss, gradient
    norm, and each rank's new parameters and moments against the blocks
    of the device at its coordinates."""
    out_dir = (outputs if shape == MESH else pod_outputs)[2]
    check_mesh_train_step(ref_dir, out_dir, NAME, shape, kind="zero3",
                          stem="zero3", keys=ZERO3_KEYS)


@pytest.mark.parametrize("shape", [MESH, POD_MESH], ids=["2x2", "2x2x2"])
def test_zero3_shards_are_the_mesh_programs_shards(ref_dir, outputs,
                                                   pod_outputs, shape):
    out_dir = (outputs if shape == MESH else pod_outputs)[2]
    check_mesh_shards(ref_dir, out_dir, NAME, shape, kind="zero3",
                      stem="zero3", prefixes=("p0",))


@pytest.mark.parametrize("what", ["forward", "greedy_even", "greedy_odd",
                                  "train_step", "shards"])
def test_granite_on_the_2x2_mesh_matches_the_mesh_program(ref_dir, outputs,
                                                          what):
    """The rank body's serve and train runs of granite-8b on the (2, 2)
    mesh (default rules) against the JAX package's on an ``Auto`` mesh."""
    out_dir = outputs[2]
    if what == "forward":
        check_mesh_forward(ref_dir, out_dir, NAME, MESH)
    elif what.startswith("greedy"):
        check_mesh_greedy(ref_dir, out_dir, NAME, MESH, what.split("_")[1])
    elif what == "train_step":
        check_mesh_train_step(ref_dir, out_dir, NAME, MESH)
    else:
        check_mesh_shards(ref_dir, out_dir, NAME, MESH)
