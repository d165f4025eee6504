"""Host data pipeline (the port's copy of ``repro/data/pipeline.py``):
background prefetch, host sharding, seekability.

On a real multi-host deployment each process constructs the stream with
its ``(host_id, num_hosts)`` slice and reads only its sub-batch; the
global step drives ``batch_at`` so every host stays in lockstep without a
data service.  Restart = seek to the checkpointed step (no replay/skip).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Optional


class Prefetcher:
    """Runs ``producer(step)`` one step ahead on a background thread."""

    def __init__(self, producer: Callable[[int], dict], start_step: int = 0,
                 depth: int = 2):
        self.producer = producer
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._next = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._next
        while not self._stop.is_set():
            try:
                item = (step, self.producer(step))
            except Exception as e:  # surface producer errors to the consumer
                self.q.put((step, e))
                return
            while not self._stop.is_set():
                try:
                    self.q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def get(self) -> tuple[int, dict]:
        step, item = self.q.get()
        if isinstance(item, Exception):
            raise item
        return step, item

    def stop(self):
        self._stop.set()


def host_slice(batch_size: int, host_id: int, num_hosts: int) -> slice:
    assert batch_size % num_hosts == 0
    per = batch_size // num_hosts
    return slice(host_id * per, (host_id + 1) * per)
