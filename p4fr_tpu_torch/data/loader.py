"""Batching, the port's copy of ``collate``, ``DataLoader`` and
``dataset_loader`` from ``p4fr_tpu/data/loader.py``:

- labels are padded with ``-1`` to a fixed ``max_label_len`` (the trainers
  map -1 to the pad id);
- the images stack to one [B, H, W, C] array per ``image_keys`` entry
  (``"image"``; distillation's ``"student_image"`` and
  ``"teacher_image"``): u8 stays u8 (the inference feed), anything else
  becomes f32 (the host-normalized feed); a canvas feed's extents stack to
  ``batch["orig_hw"]`` [B, 2] int32;
- training shuffles with a generator seeded once (its state runs on from
  epoch to epoch) and drops the last short batch; otherwise the last short
  batch is padded up to full size, and ``batch["count"]`` says how many
  rows are real;
- ``sort_key`` orders items (stable) so similar-length items share a batch;
- with ``shard=(i, n)`` (eval) each batch loads only its i-th of n equal
  slices of rows, padding included, while ``count`` and ``file_path``
  still cover the whole batch: a data-parallel rank reads its own images;
- a background thread keeps ``PREFETCH`` batches ready, so host image
  decode overlaps device compute.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

PREFETCH = 4


def collate(items: List[Dict], max_label_len: int,
            image_keys: Sequence[str] = ("image",)) -> Dict:
    """Stack a list of dataset items into fixed-shape arrays."""
    batch: Dict = {
        "path": [d["path"] for d in items],
        "truth": {"text": [d["truth"]["text"] for d in items]},
        "count": len(items),
    }
    if "file_path" in items[0]:
        batch["file_path"] = [d["file_path"] for d in items]
    encoded = np.full((len(items), max_label_len), -1, np.int32)
    for i, d in enumerate(items):
        ids = d["truth"]["encoded"][:max_label_len]
        encoded[i, : len(ids)] = ids
    batch["truth"]["encoded"] = encoded
    for key in image_keys:
        images = np.stack([d[key] for d in items])
        batch[key] = images if images.dtype == np.uint8 else images.astype(np.float32)
    if "orig_hw" in items[0]:  # the canvas feed: each image's valid (h, w)
        batch["orig_hw"] = np.stack([d["orig_hw"] for d in items]).astype(np.int32)
    return batch


class DataLoader:
    """Batch iterator with thread prefetch: in order (or by ``sort_key``),
    or with ``shuffle`` in an order drawn from ``seed``."""

    def __init__(self, dataset, batch_size: int, *, max_label_len: int = 232,
                 sort_key=None, shuffle: bool = False, drop_last: bool = False,
                 seed: int = 0, image_keys: Sequence[str] = ("image",),
                 shard: Tuple[int, int] = (0, 1)):
        if sort_key is not None and shuffle:
            raise ValueError("sort_key and shuffle are mutually exclusive")
        if batch_size % shard[1] or (shard[1] > 1 and (shuffle or drop_last)):
            raise ValueError(f"shard {shard}: an eval batch of {batch_size} rows "
                             "splits into equal slices")
        self.dataset = dataset
        self.batch_size = batch_size
        self.max_label_len = max_label_len
        self.sort_key = sort_key
        self.shuffle, self.drop_last = shuffle, drop_last
        self.image_keys = tuple(image_keys)
        self.shard = shard
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        if self.drop_last:
            return len(self.dataset) // self.batch_size
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def _index_batches(self) -> List[np.ndarray]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        elif self.sort_key is not None:
            keys = np.asarray([self.sort_key(int(i)) for i in idx])
            idx = idx[np.argsort(keys, kind="stable")]
        return [idx[s: s + self.batch_size]
                for s in range(0, len(idx), self.batch_size)][:len(self)]

    def _make_batch(self, chunk: np.ndarray) -> Dict:
        count = len(chunk)
        rows = np.concatenate([chunk, np.repeat(chunk[-1:], self.batch_size - count)])
        index, n = self.shard
        items = [self.dataset[int(i)] for i in np.split(rows, n)[index]]
        batch = collate(items, self.max_label_len, self.image_keys)
        batch["count"] = count
        if n > 1 and "file_path" in batch:
            batch["file_path"] = [self.dataset.data[int(i)]["file_path"] for i in rows]
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


def dataset_loader(options, train_transform, valid_transform, *,
                   max_label_len: int = 232):
    """(train_loader, train_dataset, valid_loader, valid_dataset) from a
    reference-schema config (``ConfigNode``)."""
    from p4fr_tpu_torch.data.dataset import LoadDataset, split_gt

    train_data, valid_data = [], []
    for path in options.data.train:
        train, valid = split_gt(path, options.data.fold)
        train_data += train
        valid_data += valid
    kw = dict(crop=options.data.crop, rgb=options.data.rgb)
    train_dataset = LoadDataset(train_data, options.data.token_paths,
                                transform=train_transform, **kw)
    valid_dataset = LoadDataset(valid_data, options.data.token_paths,
                                transform=valid_transform, **kw)
    train_loader = DataLoader(train_dataset, options.batch_size,
                              max_label_len=max_label_len, shuffle=True,
                              drop_last=True, seed=options.seed)
    valid_loader = DataLoader(valid_dataset, options.batch_size,
                              max_label_len=max_label_len)
    return train_loader, train_dataset, valid_loader, valid_dataset
