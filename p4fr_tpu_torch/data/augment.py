"""Eval-time image transform, the port's copy of the eval half of
``p4fr_tpu/data/augment.py`` with ``normalize=False``: bilinear resize
(albumentations' ``Resize``) to u8 HWC. The inference feed ships these
resized u8 images and standardizes on the card (``ops/preprocess.py``).

cv2 is imported inside ``resize``, so importing this module needs none of
it.
"""

from __future__ import annotations

import numpy as np


def resize(image: np.ndarray, height: int, width: int) -> np.ndarray:
    """A.Resize default: bilinear."""
    import cv2

    return cv2.resize(image, (width, height), interpolation=cv2.INTER_LINEAR)


class Transform:
    """Resize to (height, width); u8 HWC out."""

    def __init__(self, height: int, width: int):
        self.height = height
        self.width = width

    def __call__(self, image: np.ndarray) -> np.ndarray:
        image = resize(image, self.height, self.width)
        if image.ndim == 2:
            image = image[:, :, None]
        return image


def get_valid_transforms(height, width) -> Transform:
    return Transform(height, width)
