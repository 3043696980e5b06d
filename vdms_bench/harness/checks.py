"""The comparison that decides ``correct``: a seeded sample of the
queries the window completed, each answer held against the plain
reference (``vdms_bench/reference``) at the sizes the window ran.

Numbers (each held against its limit in ``limits/<cell>.json``):

- ``failed_queries``: queries of the window that failed or never came
  (exact: 0);
- ``find_errors``: entities a sampled response names that the metadata
  selection does not, or misses (exact: 0);
- ``image_err``: the largest absolute difference between a response's
  image and the reference's: the query's image operations on the
  ingested face, and for a model pipeline the label stamp of the token
  the program served for that image;
- with a model UDF: ``unmatched``, response images for which no row of
  the UDF's device-route calls made while their query was open carries
  the prompt the reference's image gives, allowing a pixel whose ``x *
  255`` lies within ``PROMPT_SLACK`` of an integer to truncate either
  way (exact: 0); ``logit_gap``, the widest gap by which a served
  token's logit lies below the reference's best, at every position of
  every sequence those rows served, the reference's float32 forward run
  once over each prompt with its served tokens.  Rows are found by their
  prompt, which the route takes, and by time: a query's rows are served
  after it is submitted and before its result comes.  Where several rows
  of those calls carry the image's prompt, every one is judged.

The control (:func:`control`) puts the reference computed in TF32 in
the program's place on the same sample: its images, its prompts, and at
each position of the same sequences the token TF32 puts first.
:func:`judge` holds the program's numbers and the control's to the same
limits."""
from __future__ import annotations

import numpy as np
import torch

from reference import image_ops
from reference.stamp import stamp

PROMPT_SLACK = 1e-3   # in units of x * 255
BLOCK = 64            # rows the reference takes at a time
MODEL_OP = "model_udf"


def _image_ops(pipeline):
    return [op for op in pipeline if op["type"] != MODEL_OP]


def has_model(pipeline) -> bool:
    return any(op["type"] == MODEL_OP for op in pipeline)


def _reference_images(faces, idx, pipeline, device, precision):
    x = faces[idx].to(device)
    for op in _image_ops(pipeline):
        x = image_ops.apply(op, x, precision)
    return x


class Sample:
    """The sampled responses flattened to ``(eid, face index, image,
    (submitted, done))``, the query's times since the window opened,
    with the Find's errors counted."""

    def __init__(self, kept, eids_of_group, index_of):
        self.find_errors = 0
        self.items = []
        for meta, entities, span in kept:
            want = {e for g in meta["groups"] for e in eids_of_group[g]}
            got = set(entities)
            self.find_errors += len(want ^ got)
            for eid in sorted(got & want):
                self.items.append((eid, index_of[eid],
                                   np.asarray(entities[eid], np.float32),
                                   span))


def _served_rows(calls, span, lo, hi):
    """``[(prompt, tokens)]`` of every row of the calls made within
    ``span`` whose prompt lies in ``[lo, hi]``."""
    rows = []
    for call in calls:
        if call["prompt"] is None or call["tokens"] is None:
            continue
        if not span[0] < call["start"] < call["start"] + call["seconds"] \
                < span[1]:
            continue
        prompt = call["prompt"]
        hit = ((prompt >= lo) & (prompt <= hi)).all(-1)
        for r in torch.nonzero(hit)[:, 0].tolist():
            rows.append((tuple(prompt[r].tolist()),
                         tuple(call["tokens"][r].tolist())))
    return rows


def evaluate(sample: Sample, faces, pipeline, device, calls=None,
             model=None) -> tuple[dict, set]:
    """The program's numbers on ``sample`` but ``logit_gap`` (see
    :func:`logit_gaps`), and the served sequences to judge there.
    ``model`` is ``{"cfg", "labels"}`` for a model pipeline."""
    numbers = {"find_errors": sample.find_errors, "image_err": 0.0}
    sequences: set = set()
    served = has_model(pipeline)
    if served:
        numbers["unmatched"] = 0
        vocab = model["cfg"]["vocab_size"]
        labels = model["labels"]
    for b0 in range(0, len(sample.items), BLOCK):
        block = sample.items[b0:b0 + BLOCK]
        ref = _reference_images(faces, [it[1] for it in block], pipeline,
                                device, "fp32")
        if served:
            lo, hi = (t.cpu().to(torch.int64) for t in
                      image_ops.prompt_range(ref, vocab, PROMPT_SLACK))
        for j, (_, _, got, span) in enumerate(block):
            want = ref[j]
            if not served:
                err = float((torch.from_numpy(got).to(device) - want)
                            .abs().max())
                numbers["image_err"] = max(numbers["image_err"], err)
                continue
            rows = _served_rows(calls or [], span, lo[j], hi[j])
            if not rows:
                numbers["unmatched"] += 1
                continue
            errs = []
            for prompt, tokens in rows:
                label = labels[tokens[-1] % len(labels)]
                errs.append(float((torch.from_numpy(got).to(device)
                                   - stamp(want, label)).abs().max()))
                sequences.add((prompt, tokens))
            numbers["image_err"] = max(numbers["image_err"], min(errs))
    return numbers, sequences


def logit_gaps(sequences, params, cfg, forward, device,
               control: bool = False) -> float:
    """The widest gap, over every position of every ``(prompt, served
    tokens)`` sequence, between the float32 reference's best logit and
    its logit of the served token; with ``control``, of the token the
    TF32 reference puts first at that position."""
    widest = 0.0
    seqs = sorted(sequences)
    for b0 in range(0, len(seqs), BLOCK):
        block = seqs[b0:b0 + BLOCK]
        S = len(block[0][0])
        steps = len(block[0][1])
        toks = torch.tensor([list(p) + list(t[:-1]) for p, t in block],
                            device=device)
        served = torch.tensor([list(t) for _, t in block], device=device)
        with torch.no_grad():
            logits = forward(params, toks, cfg, "fp32")[:, S - 1:S - 1 + steps]
            if control:
                low = forward(params, toks, cfg, "tf32")[:, S - 1:S - 1 + steps]
                served = low.argmax(-1)
        best = logits.max(-1).values
        got = logits.gather(-1, served[..., None])[..., 0]
        widest = max(widest, float((best - got).max()))
    return widest


def control(sample: Sample, faces, pipeline, device, model=None) -> dict:
    """The control's numbers on the same sample: the reference computed
    in TF32 in the program's place (its images; with a model, its prompt
    from its own image, ``unmatched`` where that lies outside the
    reference's).  ``logit_gap`` comes from :func:`logit_gaps`."""
    numbers = {"image_err": 0.0}
    if has_model(pipeline):
        numbers["unmatched"] = 0
        vocab = model["cfg"]["vocab_size"]
    for b0 in range(0, len(sample.items), BLOCK):
        idx = [it[1] for it in sample.items[b0:b0 + BLOCK]]
        ref = _reference_images(faces, idx, pipeline, device, "fp32")
        low = _reference_images(faces, idx, pipeline, device, "tf32")
        numbers["image_err"] = max(numbers["image_err"],
                                   float((low - ref).abs().max()))
        if has_model(pipeline):
            lo, hi = image_ops.prompt_range(ref, vocab, PROMPT_SLACK)
            p = image_ops.prompt(low, vocab)
            numbers["unmatched"] += int(((p < lo) | (p > hi))
                                        .any(-1).sum())
    return numbers


def judge(numbers: dict, limits: dict) -> tuple[dict, bool]:
    """Each number beside its limit, and whether every one keeps to it
    (a number without a limit does not)."""
    compared = {k: {"value": numbers[k], "limit": limits.get(k)}
                for k in sorted(numbers)}
    ok = all(c["limit"] is not None and c["value"] <= c["limit"]
             for c in compared.values())
    return compared, ok
