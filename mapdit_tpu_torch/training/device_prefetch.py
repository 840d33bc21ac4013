"""Device-staging prefetcher, port of ``mapdit_tpu/training/device_prefetch.py``:
a background thread stages batch k+1 onto the device while step k runs.

``make_stage_fn(device)`` is the staging the train loop uses inline or hands
to :class:`DevicePrefetcher`: on CUDA the host arrays go through pinned
memory and a ``non_blocking`` copy on a side stream, the staging thread waits
for the copy, and the tensors are handed to the consumer's stream
(``record_stream``), so the train step never sees a half-copied batch.
Depth 2 bounds the device memory at one extra batch.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

_SENTINEL = object()


def make_stage_fn(device) -> Callable[[Dict[str, np.ndarray]], Dict[str, torch.Tensor]]:
    """``stage(host_batch) -> {name: tensor on device}``."""
    device = torch.device(device)
    if device.type != "cuda":
        return lambda host_batch: {k: torch.as_tensor(v).to(device) for k, v in host_batch.items()}
    side: Optional[torch.cuda.Stream] = None

    def stage(host_batch):
        nonlocal side
        if threading.current_thread() is threading.main_thread():
            return {k: torch.as_tensor(v).to(device) for k, v in host_batch.items()}
        if side is None:
            side = torch.cuda.Stream(device)
        consumer = torch.cuda.default_stream(device)
        with torch.cuda.stream(side):
            out = {k: torch.as_tensor(v).pin_memory().to(device, non_blocking=True) for k, v in host_batch.items()}
        side.synchronize()  # on the staging thread; the train loop runs on
        for t in out.values():
            t.record_stream(consumer)
        return out

    return stage


class DevicePrefetcher:
    """Wrap a host-batch iterator; yield device-staged batches, staged
    ``depth`` ahead by a background thread."""

    def __init__(self, host_batches: Iterator[dict], stage_fn: Callable[[dict], dict], depth: int = 2):
        if depth < 1:
            raise ValueError("depth must be at least 1")
        self._it = host_batches
        self._stage = stage_fn
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._done = False
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True, name="device-prefetch")
        self._t.start()

    def _put(self, item) -> bool:
        """Bounded put that stays responsive to close()."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self):
        try:
            for hb in self._it:
                if not self._put(self._stage(hb)):
                    return
        except BaseException as e:  # re-raised on the consumer thread
            self._err = e
        self._put(_SENTINEL)

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            if self._err is not None:
                raise self._err
            raise StopIteration
        item = self._q.get()
        if item is _SENTINEL:
            self._done = True
            self.close()
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self):
        """Stop the producer and join it (idempotent). Staged batches that
        were not consumed are dropped: a resumed run takes its data cursor
        from the checkpointed step, not from the iterator's position."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        if self._t is not threading.current_thread():
            self._t.join(timeout=10)
