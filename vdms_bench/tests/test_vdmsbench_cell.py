"""A whole run of each cell on the CPU at a small size (the program's
reduced models, a small collection and small images): it comes out
correct; with each fault the cell can have planted by the test under
the timed path (monkeypatched on the program's own seams), it does not;
and the control, the reference computed in TF32 in the program's place
and judged by the same limits, is not correct.  The look for a card is
skipped (``device="cpu"``); the limits are the cells' own."""
import dataclasses
import importlib
import time

import pytest

import _paths  # noqa: F401
from harness import cell, spec

SEED = 2**32 + 77


@pytest.fixture(autouse=True)
def _few_threads():
    """Two intra-op threads while the test runs (restored after), so that
    the engine's threads and torch's do not crowd the test workers that
    share the host."""
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _small(name):
    from repro_torch.configs import get_arch
    bench = spec.benchmark()
    entry = spec.workload(bench, name)
    cfg = spec.config(bench, entry["config"])
    arch = dataclasses.asdict(get_arch(cfg["model"]["arch"], reduced=True))
    cfg["model"] = {k: arch.get(k, v) for k, v in cfg["model"].items()}
    cfg["collection"].update(images=48, size=40, group_size=8)
    mix = spec.traffic(entry["traffic"])
    sizes = {"resize": dict(width=36, height=36),
             "crop": dict(x=2, y=2, width=32, height=32)}
    mix["pipeline"] = [dict(op, **sizes.get(op["type"], {}))
                       for op in mix["pipeline"]]
    mix.update(clients=2, groups_per_query=min(mix["groups_per_query"], 2),
               device_batch_size=16, device_max_wait_ms=2.0)
    return bench, cfg, mix


def _run(name, control=False):
    bench, cfg, mix = _small(name)
    return cell.run(name, SEED, 0.3, False, t_start=time.monotonic(),
                    device="cpu", bench=bench, config=cfg, traffic=mix,
                    program_reduced=True, control=control)


CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    res = _run(name, control=True)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in spec.metrics(
        spec.benchmark(), name, False)}
    assert list(res)[-1] == "checks"
    # the control, judged by the same limits, is not correct
    assert not res["control_correct"], res["control"]


def _token(monkeypatch):
    """Every greedy token of the first row one id off, where it is
    chosen."""
    ss = importlib.import_module("repro_torch.serving.serve_step")
    sample = ss.sample_token

    def altered(logits, *a, **kw):
        tok = sample(logits, *a, **kw).clone()
        tok[0] = (tok[0] + 1) % logits.shape[-1]
        return tok

    monkeypatch.setattr(ss, "sample_token", altered)


def _state(monkeypatch):
    """Each decode step leaves the recurrent state as it found it."""
    ss = importlib.import_module("repro_torch.serving.serve_step")
    make = ss.make_serve_fns

    def make_serve_fns(*a, **kw):
        prefill, step = make(*a, **kw)

        def kept(params, tokens, cache, cache_index):
            before = {k: v.clone() for k, v in cache.items()}
            logits, cache = step(params, tokens, cache, cache_index)
            for k, v in before.items():
                cache[k].copy_(v)
            return logits, cache

        return prefill, kept

    monkeypatch.setattr(ss, "make_serve_fns", make_serve_fns)


def _image(monkeypatch):
    """The device backend's batched blur adds 0.01 to one value of its
    first image."""
    db = importlib.import_module("repro_torch.query.device_backend")
    blur = db.DEVICE_BATCH_PATHS["blur"]

    def altered(batch, **kw):
        out = blur(batch, **kw).clone()
        out[0, 0, 0, 0] += 0.01
        return out

    monkeypatch.setitem(db.DEVICE_BATCH_PATHS, "blur", altered)


def _find(monkeypatch):
    """The metadata selection drops its last entity."""
    md = importlib.import_module("repro_torch.query.metadata")
    find = md.MetadataStore.find_ids
    monkeypatch.setattr(md.MetadataStore, "find_ids",
                        lambda self, *a, **kw: find(self, *a, **kw)[:-1])


FAULTS = {"token": _token, "state": _state, "image": _image, "find": _find}
CELL_FAULTS = [(n, f) for n in CELLS for f in ("token", "state", "find")
               if "classify" in n] + [(n, f) for n in CELLS
                                      for f in ("image", "find")
                                      if "preprocess" in n]


@pytest.mark.parametrize("name,fault", CELL_FAULTS)
def test_a_planted_fault_is_not_correct(name, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    res = _run(name)
    assert not res["correct"], res["checks"]
