"""Double-buffered data loader.

A background thread prefetches the next batches while the device
computes — the standard input-pipeline overlap, host-side twin of the
paper's "never idle-wait" principle.  One process loads the whole batch
(the JAX package's per-host sharding over the data axis comes with
meshes)."""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator


class ShardedLoader:
    def __init__(self, make_batch: Callable[[int], dict], *,
                 prefetch: int = 2, start_step: int = 0):
        """make_batch(step) -> dict of np arrays."""
        self.make_batch = make_batch
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._step = start_step
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop:
            batch = self.make_batch(step)
            self._q.put((step, batch))
            step += 1

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        return self

    def __next__(self):
        return self._q.get()

    def stop(self):
        """Stop the producer and wait for it to end (it finishes the
        batch it is making)."""
        self._stop = True
        while self._thread.is_alive():
            try:  # unblock the producer
                self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)
