"""State carried across from an engine of the JAX package.

The query engine runs no model, so its state is its data: metadata rows
and blobs.  :func:`engine_state` reads them from an engine of the JAX
package (its ``meta.find``/``store.get`` layout) as
``(eid, kind, array, properties)`` records, and
:func:`ingest_reference_state` ingests such records into a port engine
keeping their eids, so the two engines answer one query over the same
data.
"""
from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np

KINDS = ("image", "video")


def engine_state(engine, kinds=KINDS) -> Iterator[tuple]:
    """``(eid, kind, np.ndarray, properties)`` for every entity of
    ``kinds`` in the JAX package's ``engine``, in eid order per kind."""
    for kind in kinds:
        for eid in engine.meta.find(kind):
            yield (eid, kind, np.asarray(engine.store.get(eid)),
                   engine.meta.get(eid))


def ingest_reference_state(engine, entities: Iterable[tuple]) -> list[str]:
    """Ingest ``(eid, kind, array, properties)`` records into the port
    ``engine`` under their own eids; returns the eids."""
    return [engine.add_entity(kind, np.asarray(data), dict(props), eid=eid)
            for eid, kind, data, props in entities]
