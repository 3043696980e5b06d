"""The benchmark's probes on the program under test, taken at seams the
program already has, without editing it:

- :class:`ServeRecorder`: the model UDF's device route, re-registered
  under its own name behind a span (rows, seconds), and the two
  functions of the serving step that route binds when it is registered
  (``make_serve_fns`` and ``sample_token`` of
  ``repro_torch.serving.serve_step``), wrapped while it registers: per
  call, the prompt tokens the prefill was fed, the token each greedy
  step chose, and the passes run (rows, new tokens, cached positions).
- :class:`KernelProbe`: in a traced run, the launching function of
  each kernel that a metric reader names (its ``PROBE``) wrapped in a
  ``torch.profiler.record_function`` range that names the reader and
  the launch's shape, so that the trace gives each launch's device
  time beside the work it had to do."""
from __future__ import annotations

import contextlib
import importlib
import json
import threading
import time

import torch


class ServeRecorder:
    def __init__(self):
        self.calls: list[dict] = []
        self._local = threading.local()

    def _current(self):
        return getattr(self._local, "rec", None)

    @contextlib.contextmanager
    def registering(self):
        """Within the block, a model UDF registered binds the wrapped
        serving functions; outside it the program's own are in place."""
        ss = importlib.import_module("repro_torch.serving.serve_step")
        make, sample = ss.make_serve_fns, ss.sample_token
        ss.make_serve_fns = self._wrap_make(make)
        ss.sample_token = self._wrap_sample(sample)
        try:
            yield
        finally:
            ss.make_serve_fns, ss.sample_token = make, sample

    def wrap_device_route(self, name: str) -> None:
        udf = importlib.import_module("repro_torch.core.udf")
        route = udf.get_device_udf(name)

        def served(imgs, **kw):
            rec = {"rows": len(imgs), "passes": [], "tokens": [],
                   "prompt": None}
            self._local.rec = rec
            t0 = rec["start"] = time.perf_counter()
            try:
                return route(imgs, **kw)
            finally:
                rec["seconds"] = time.perf_counter() - t0
                self._local.rec = None
                self.calls.append(rec)

        udf.register_device_udf(name, served)

    def _wrap_make(self, make):
        recorder = self

        def make_serve_fns(model, sh, *a, **kw):
            prefill_fn, serve_step = make(model, sh, *a, **kw)

            def prefill(params, batch, max_cache):
                rec = recorder._current()
                if rec is not None:
                    tokens = batch["tokens"]
                    rec["prompt"] = tokens
                    rec["passes"].append((tokens.shape[0], tokens.shape[1],
                                          0, 1))
                return prefill_fn(params, batch, max_cache)

            def step(params, tokens, cache, cache_index):
                rec = recorder._current()
                if rec is not None:
                    rec["passes"].append((tokens.shape[0], tokens.shape[1],
                                          int(cache_index), 1))
                return serve_step(params, tokens, cache, cache_index)

            return prefill, step

        return make_serve_fns

    def _wrap_sample(self, sample):
        recorder = self

        def sample_token(logits, *a, **kw):
            tok = sample(logits, *a, **kw)
            rec = recorder._current()
            if rec is not None:
                rec["tokens"].append(tok)
            return tok

        return sample_token

    def host_calls(self) -> list[dict]:
        """Every call with its tensors on the host: ``prompt`` (B, S),
        ``tokens`` (B, steps)."""
        out = []
        for rec in self.calls:
            out.append({
                "rows": rec["rows"], "seconds": rec["seconds"],
                "start": rec["start"],
                "passes": rec["passes"],
                "prompt": None if rec["prompt"] is None
                else rec["prompt"].cpu().to(torch.int64),
                "tokens": torch.cat([t.reshape(rec["rows"], -1)
                                     for t in rec["tokens"]], 1)
                .cpu().to(torch.int64) if rec["tokens"] else None})
        return out


PREFIX = "vdmsbench.launch|"


class KernelProbe:
    """Wraps the launching function ``module.function`` of each probe in
    a profiler range labelled with the probe's name and the launch's
    shape (``shape(*args, **kwargs)``, a dict of numbers)."""

    def __init__(self, probes: dict):
        self.probes = probes      # name -> (module, function, shape)
        self._undo = []

    def install(self) -> None:
        for name, (mod_name, fn_name, shape_of) in self.probes.items():
            mod = importlib.import_module(mod_name)
            launch = getattr(mod, fn_name)

            def wrapped(*a, _launch=launch, _name=name, _shape=shape_of,
                        **kw):
                label = PREFIX + _name + "|" + json.dumps(_shape(*a, **kw))
                with torch.profiler.record_function(label):
                    return _launch(*a, **kw)

            setattr(mod, fn_name, wrapped)
            self._undo.append((mod, fn_name, launch))

    def remove(self) -> None:
        for mod, fn_name, launch in reversed(self._undo):
            setattr(mod, fn_name, launch)
        self._undo.clear()
