"""Entities per group the device backend ran over the steady part of
the window (its ``entities_run`` over ``groups_run``, differences)."""


def read(run):
    before, after = run.backend
    groups = after["groups_run"] - before["groups_run"]
    if groups <= 0:
        return None
    return (after["entities_run"] - before["entities_run"]) / groups
