"""Threaded prefetching around the data loader (counterpart of
`tpudenoise/data/prefetch.py`).

The reference's RoIDataLayer is strictly synchronous: every train step
blocks on cv2.imread + the host noise pipeline (ref lib/roi_data_layer/
layer.py:85-88, SURVEY.md §3.1 hot loop).  With noise on device, the only
host work left is JPEG decode + resize — this wrapper overlaps it with the
device step using a background thread and a bounded queue.

State protocol: each produced batch is queued together with the inner
cursor state taken right after producing it; `get_state` returns the state
of the last batch the CONSUMER actually received (not the inner cursor,
which runs ahead by the queued batches), so snapshot/restore is exact:
prefetched-but-unconsumed batches are discarded and re-produced.
"""

from __future__ import annotations

import queue
import threading


class PrefetchLoader:
    def __init__(self, loader, depth: int = 2):
        self._loader = loader
        self._depth = depth
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None
        # cursor state the consumer has logically reached (before the
        # worker runs ahead)
        self._consumed_state = loader.get_state()
        self._start()

    def _start(self):
        self._stop.clear()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while not self._stop.is_set():
            with self._lock:
                batch = self._loader.forward()
                post_state = self._loader.get_state()
            item = (batch, post_state)
            while not self._stop.is_set():
                try:
                    self._queue.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def forward(self):
        batch, post_state = self._queue.get()
        # cursor state AFTER the last batch the consumer actually saw —
        # snapshotting this (not the inner cursor, which has run ahead by
        # the queued batches) keeps resume exact
        self._consumed_state = post_state
        return batch

    # --- checkpointable cursor protocol ---
    def get_state(self):
        return self._consumed_state

    def set_state(self, state):
        self._stop.set()
        self._thread.join(timeout=5)
        while not self._queue.empty():
            self._queue.get_nowait()
        self._loader.set_state(state)
        self._consumed_state = self._loader.get_state()
        self._start()

    def close(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
