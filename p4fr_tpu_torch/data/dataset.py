"""Datasets, the port's copy of ``split_gt``, ``load_image``,
``LoadDataset``, ``LoadEvalDataset`` and ``DistillationDataset`` from
``p4fr_tpu/data/dataset.py``.

Ground truth is a TSV of ``image_name\tlatex tokens``; ``split_gt`` joins
it against ``data_info.txt`` (CSV with image_name,fold columns):
validation = the rows whose fold is k, train = the rest, in an order
shuffled by Python's ``random`` (seeded by the trainer). Images:
RGB/greyscale select, the optional invert-bbox crop (training), rotate 90
degrees when h/w > 2, then the transform; labels are pre-encoded
``<SOS> ... <EOS>`` at construction time. PIL is imported inside the
functions that open images, so importing this module needs none of it.
"""

from __future__ import annotations

import csv
import os
import random
from typing import Dict, List, Sequence, Tuple

import numpy as np

from p4fr_tpu_torch.data.vocab import Vocab


def split_gt(groundtruth: str, fold: int
             ) -> Tuple[List[Tuple[str, str]], List[Tuple[str, str]]]:
    """(train, valid) lists of (image_path, latex) via the fold column."""
    root = os.path.join(os.path.dirname(groundtruth), "images")
    with open(os.path.join(os.path.dirname(groundtruth), "data_info.txt"),
              newline="") as f:
        folds = {row["image_name"]: int(row["fold"]) for row in csv.DictReader(f)}
    data = []
    with open(groundtruth, "r") as fd:
        for line in fd:
            parts = line.strip().split("\t")
            if len(parts) >= 2:
                data.append(parts[:2])
    random.shuffle(data)
    train = [(os.path.join(root, n), t) for n, t in data
             if n in folds and folds[n] != fold]
    valid = [(os.path.join(root, n), t) for n, t in data if folds.get(n) == fold]
    return train, valid


def load_image(path: str, rgb: int = 3, crop: bool = False) -> np.ndarray:
    """PIL load -> uint8 array with the original code's crop and rotate
    rules."""
    from PIL import Image, ImageOps

    image = Image.open(path)
    if rgb == 3:
        image = image.convert("RGB")
    elif rgb == 1:
        image = image.convert("L")
    else:
        raise NotImplementedError(f"rgb={rgb}")
    if crop:
        bbox = ImageOps.invert(image.convert("RGB") if rgb == 1 else image).getbbox()
        if bbox is not None:
            image = image.crop(bbox)
    w, h = image.size
    if h / w > 2:
        image = image.rotate(90, expand=True)
    return np.array(image)


class LoadDataset:
    """Training/validation dataset of (image_path, latex) pairs."""

    def __init__(self, groundtruth: Sequence[Tuple[str, str]],
                 token_paths: Sequence[str], *, crop: bool = False,
                 transform=None, rgb: int = 3):
        self._setup(Vocab.from_files(token_paths), crop, transform, rgb)
        self.data = [{"path": p, "truth": self._truth(t)} for p, t in groundtruth]

    def _setup(self, vocab: Vocab, crop: bool, transform, rgb: int) -> None:
        self.vocab, self.crop, self.transform, self.rgb = vocab, crop, transform, rgb

    def _truth(self, text: str) -> Dict:
        v = self.vocab
        return {"text": text, "encoded": [v.sos_id, *v.encode(text), v.eos_id]}

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, i: int) -> Dict:
        item = dict(self.data[i])
        image = load_image(item["path"], self.rgb, self.crop)
        item["image"] = image if self.transform is None else self.transform(image)
        if isinstance(item["image"], tuple):  # canvas mode: the device resize's extent
            item["image"], hw = item["image"]
            item["orig_hw"] = np.array(hw, np.int32)
        return item


class LoadEvalDataset(LoadDataset):
    """Eval dataset carrying the original file path column (no crop)."""

    def __init__(
        self,
        groundtruth: Sequence[Tuple[str, str, str]],  # (path, file_path, truth)
        token_to_id: Dict[str, int],
        id_to_token: Dict[int, str],
        *,
        transform=None,
        rgb: int = 3,
    ):
        self._setup(Vocab.from_maps(token_to_id, id_to_token), False, transform, rgb)
        self.data = [{"path": p, "file_path": fp, "truth": self._truth(t)}
                     for p, fp, t in groundtruth]

    def size_proxy(self, i: int) -> float:
        """Aspect ratio from the PNG header (no pixel decode): wide images
        hold long formulas, so sorting eval batches by this groups
        similar decode lengths for the early-exit loop."""
        from PIL import Image

        with Image.open(self.data[i]["path"]) as im:
            w, h = im.size
        return w / max(h, 1)


class DistillationDataset(LoadDataset):
    """The same image under the student's and the teacher's transforms
    (``p4fr_tpu/data/dataset.py::DistillationDataset``): items carry
    ``student_image`` and ``teacher_image``."""

    def __init__(self, groundtruth: Sequence[Tuple[str, str]],
                 token_paths: Sequence[str], *, crop: bool = False,
                 student_transform=None, teacher_transform=None, rgb: int = 3):
        super().__init__(groundtruth, token_paths, crop=crop, transform=None, rgb=rgb)
        self.student_transform = student_transform
        self.teacher_transform = teacher_transform

    def __getitem__(self, i: int) -> Dict:
        item = self.data[i]
        image = load_image(item["path"], self.rgb, self.crop)
        return {
            "path": item["path"],
            "truth": item["truth"],
            "student_image": (self.student_transform(image)
                              if self.student_transform else image),
            "teacher_image": (self.teacher_transform(image)
                              if self.teacher_transform else image),
        }
