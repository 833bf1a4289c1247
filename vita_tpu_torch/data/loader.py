"""Async batch prefetching — the DataLoader-worker equivalent (a copy of
vita_tpu.data.loader, so that the port loads no module of the reference
package).

The reference overlaps CPU media decode with GPU compute via torch
DataLoader worker processes (train.py dataloader_num_workers). Here a
thread pool builds samples (PIL/cv2/fbank release the GIL in their C
paths) and a bounded queue keeps `prefetch` collated batches ready while
the device runs the previous step.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence


class PrefetchLoader:
    """Iterate collated batches with background sample building."""

    def __init__(
        self,
        dataset,
        order: Sequence[int],
        batch_size: int,
        collate: Callable[[List[Dict]], Dict],
        num_workers: int = 4,
        prefetch: int = 2,
        drop_last: bool = True,
    ):
        self.dataset = dataset
        self.order = list(order)
        self.batch_size = batch_size
        self.collate = collate
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.drop_last = drop_last

    def __len__(self) -> int:
        n = len(self.order) // self.batch_size
        if not self.drop_last and len(self.order) % self.batch_size:
            n += 1
        return n

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        SENTINEL = object()

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    bs = self.batch_size
                    end = len(self.order) if not self.drop_last else (
                        len(self.order) // bs * bs
                    )
                    for i in range(0, end, bs):
                        if stop.is_set():
                            return
                        idxs = self.order[i : i + bs]
                        samples = list(pool.map(self.dataset.__getitem__, idxs))
                        out_q.put(self.collate(samples))
            except Exception as e:  # surface in the consumer thread
                out_q.put(e)
            finally:
                out_q.put(SENTINEL)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = out_q.get()
                if item is SENTINEL:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
