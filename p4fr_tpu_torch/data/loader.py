"""Batching for inference, the port's copy of ``collate`` and ``DataLoader``
from ``p4fr_tpu/data/loader.py`` (eval use only):

- labels are padded with ``-1`` to a fixed ``max_label_len``;
- the u8 images stack to one [B, H, W, C] u8 array;
- the last short batch is padded up to full size, and ``batch["count"]``
  says how many rows are real;
- ``sort_key`` orders items (stable) so similar-length items share a batch;
- a background thread keeps ``PREFETCH`` batches ready, so host image
  decode overlaps device compute.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List

import numpy as np

PREFETCH = 4


def collate(items: List[Dict], max_label_len: int) -> Dict:
    """Stack a list of dataset items into fixed-shape arrays."""
    batch: Dict = {
        "path": [d["path"] for d in items],
        "file_path": [d["file_path"] for d in items],
        "truth": {"text": [d["truth"]["text"] for d in items]},
        "count": len(items),
    }
    encoded = np.full((len(items), max_label_len), -1, np.int32)
    for i, d in enumerate(items):
        ids = d["truth"]["encoded"][:max_label_len]
        encoded[i, : len(ids)] = ids
    batch["truth"]["encoded"] = encoded
    batch["image"] = np.stack([d["image"] for d in items])
    return batch


class DataLoader:
    """In-order batch iterator with thread prefetch."""

    def __init__(self, dataset, batch_size: int, *, max_label_len: int = 232,
                 sort_key=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.max_label_len = max_label_len
        self.sort_key = sort_key

    def __len__(self) -> int:
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def _index_batches(self) -> List[np.ndarray]:
        idx = np.arange(len(self.dataset))
        if self.sort_key is not None:
            keys = np.asarray([self.sort_key(int(i)) for i in idx])
            idx = idx[np.argsort(keys, kind="stable")]
        return [idx[s: s + self.batch_size]
                for s in range(0, len(idx), self.batch_size)]

    def _make_batch(self, chunk: np.ndarray) -> Dict:
        items = [self.dataset[int(i)] for i in chunk]
        count = len(items)
        items = items + [items[-1]] * (self.batch_size - count)
        batch = collate(items, self.max_label_len)
        batch["count"] = count
        return batch

    def __iter__(self) -> Iterator[Dict]:
        batches = self._index_batches()
        q: queue.Queue = queue.Queue(maxsize=PREFETCH)
        sentinel = object()

        def producer():
            try:
                for chunk in batches:
                    q.put(self._make_batch(chunk))
            except Exception as exc:  # re-raised by the consumer below
                q.put(exc)
                return
            q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            if isinstance(item, Exception):
                raise item
            yield item
