"""Bytes the device backend staged onto the device per image it ran in
the steady part of the window (its ``h2d_bytes`` over
``entities_run``, differences): the stacked partitions, padding rows
included."""


def read(run):
    before, after = run.backend
    ents = after["entities_run"] - before["entities_run"]
    if ents <= 0:
        return None
    return (after["h2d_bytes"] - before["h2d_bytes"]) / ents
