"""Input pipeline: background prefetch and the put onto a rank's device.

The counterpart of ``repro.data.pipeline``.  :class:`Prefetcher` keeps
``depth`` batches ready in a daemon thread, so host data generation
overlaps device compute.  :func:`device_put_batch` takes the rows a data
rank trains on (the reference's ``batch_spec`` splits the global batch
over the ``data`` axis; here each rank of a ``(dp, mp)`` mesh takes its
rows, :func:`repro_torch.runtime.train_loop.rank_rows`) and places them on
the rank's device.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch


class Prefetcher:
    def __init__(
        self,
        source: Iterator[Dict],
        *,
        depth: int = 2,
    ) -> None:
        self.source = source
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        try:
            for batch in self.source:
                if self._stop.is_set():
                    return
                self.q.put(batch)
            self.q.put(None)  # end-of-stream sentinel
        except BaseException as e:  # surfaced on next()
            self._exc = e
            self.q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is None:
            if self._exc is not None:
                raise self._exc
            raise StopIteration
        return item

    def close(self) -> None:
        self._stop.set()
        try:
            self.q.get_nowait()
        except queue.Empty:
            pass


def device_put_batch(batch: Dict[str, Any], device: Any,
                     rows: Any = None) -> Dict[str, torch.Tensor]:
    """Host batch (arrays or tensors) -> tensors on ``device``; with
    ``rows`` (a slice or an index array) only those rows of each entry."""
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
        if rows is not None:
            t = t[rows]
        out[k] = t.to(device)
    return out
