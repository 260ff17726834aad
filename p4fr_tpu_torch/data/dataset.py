"""The eval dataset, the port's copy of ``LoadEvalDataset`` and
``load_image`` from ``p4fr_tpu/data/dataset.py``.

Images: RGB/greyscale select, rotate 90 degrees when h/w > 2 (eval loads
with no crop), then the transform; labels are pre-encoded
``<SOS> ... <EOS>`` at construction time. PIL is imported inside the
functions that open images, so importing this module needs none of it.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from p4fr_tpu_torch.data.vocab import Vocab


def load_image(path: str, rgb: int = 3) -> np.ndarray:
    """PIL load -> uint8 array with the original code's rotate rule."""
    from PIL import Image

    image = Image.open(path)
    if rgb == 3:
        image = image.convert("RGB")
    elif rgb == 1:
        image = image.convert("L")
    else:
        raise NotImplementedError(f"rgb={rgb}")
    w, h = image.size
    if h / w > 2:
        image = image.rotate(90, expand=True)
    return np.array(image)


class LoadEvalDataset:
    """Eval dataset carrying the original file path column."""

    def __init__(
        self,
        groundtruth: Sequence[Tuple[str, str, str]],  # (path, file_path, truth)
        token_to_id: Dict[str, int],
        id_to_token: Dict[int, str],
        *,
        transform=None,
        rgb: int = 3,
    ):
        self.transform = transform
        self.rgb = rgb
        vocab = Vocab.from_maps(token_to_id, id_to_token)
        self.data = [
            {
                "path": p,
                "file_path": fp,
                "truth": {
                    "text": truth,
                    "encoded": [vocab.sos_id, *vocab.encode(truth), vocab.eos_id],
                },
            }
            for p, fp, truth in groundtruth
        ]

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, i: int) -> Dict:
        item = self.data[i]
        image = load_image(item["path"], self.rgb)
        if self.transform is not None:
            image = self.transform(image)
        return {"path": item["path"], "file_path": item["file_path"],
                "truth": item["truth"], "image": image}

    def size_proxy(self, i: int) -> float:
        """Aspect ratio from the PNG header (no pixel decode): wide images
        hold long formulas, so sorting eval batches by this groups
        similar decode lengths for the early-exit loop."""
        from PIL import Image

        with Image.open(self.data[i]["path"]) as im:
            w, h = im.size
        return w / max(h, 1)
