"""Image transforms, the port's copy of ``p4fr_tpu/data/augment.py``
(the reference albumentations pipeline, on the host in cv2/NumPy):

- train: Resize -> ShiftScaleRotate (shift 0, scale +-0.1, rotate 0,
  p=0.3) -> GridDistortion (8 steps, +-0.5, nearest, zero border, p=0.3)
  -> ImageNet Normalize, f32 HWC (``get_train_transforms``);
- eval: Resize (bilinear) -> u8 HWC, which the inference feed
  standardizes on the card (``ops/preprocess.py``), or with
  ``normalize=True`` the host-normalized f32 the trainers validate on and
  ``--preprocess host`` feeds; or, with ``canvas=(Hc, Wc)``, no resize at
  all: the raw u8 image edge-replicated onto a fixed canvas and its valid
  (h, w) (``to_canvas``), which ``--preprocess device_resize`` resizes on
  the card (``ops/preprocess.py::resize_standardize``).

cv2 is imported inside the functions that call it, so importing this
module needs none of it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
AUG_PROB = 0.3  # each train augmentation's probability


def resize(image: np.ndarray, height: int, width: int) -> np.ndarray:
    """A.Resize default: bilinear."""
    import cv2

    return cv2.resize(image, (width, height), interpolation=cv2.INTER_LINEAR)


def normalize(image: np.ndarray, rgb: int = 3) -> np.ndarray:
    """albumentations.Normalize: (x/255 - mean)/std, ImageNet stats
    (their means for greyscale)."""
    x = image.astype(np.float32) / 255.0
    if rgb == 3:
        return (x - IMAGENET_MEAN) / IMAGENET_STD
    return (x - IMAGENET_MEAN.mean()) / IMAGENET_STD.mean()


def shift_scale_rotate(image: np.ndarray, rng: np.random.Generator,
                       scale_limit: float = 0.1) -> np.ndarray:
    """ShiftScaleRotate with shift=0, rotate=0: a random scale about the
    image center."""
    import cv2

    scale = 1.0 + rng.uniform(-scale_limit, scale_limit)
    h, w = image.shape[:2]
    m = cv2.getRotationMatrix2D((w / 2 - 0.5, h / 2 - 0.5), 0.0, scale)
    return cv2.warpAffine(image, m, (w, h), flags=cv2.INTER_LINEAR,
                          borderMode=cv2.BORDER_REFLECT_101)


def grid_distortion(image: np.ndarray, rng: np.random.Generator,
                    num_steps: int = 8, distort_limit: float = 0.5) -> np.ndarray:
    """GridDistortion: a random stretch of each grid cell of the coordinate
    map (nearest interpolation, zero border)."""
    import cv2

    h, w = image.shape[:2]
    xsteps = 1 + rng.uniform(-distort_limit, distort_limit, num_steps + 1)
    ysteps = 1 + rng.uniform(-distort_limit, distort_limit, num_steps + 1)

    def axis_map(size, steps):
        step = size // num_steps
        xx = np.zeros(size, np.float32)
        prev = 0.0
        for idx in range(num_steps + 1):
            x = idx * step
            start, end = int(x), int(min(x + step, size))
            cur = prev + step * steps[idx]
            if end > start:
                xx[start:end] = np.linspace(prev, cur, end - start, endpoint=False)
            prev = cur
        return xx

    map_x = np.tile(axis_map(w, xsteps)[None, :], (h, 1))
    map_y = np.tile(axis_map(h, ysteps)[:, None], (1, w))
    return cv2.remap(image, map_x, map_y, interpolation=cv2.INTER_NEAREST,
                     borderMode=cv2.BORDER_CONSTANT, borderValue=0)


def to_canvas(image: np.ndarray, canvas_h: int, canvas_w: int
              ) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Raw u8 image -> (its edge-replicated [canvas_h, canvas_w, C] canvas,
    its (h, w)). The device resize samples at most half a pixel past the
    valid region, so the replicated edge reproduces cv2's boundary clamp."""
    if image.ndim == 2:
        image = image[:, :, None]
    h, w = image.shape[:2]
    if h > canvas_h or w > canvas_w:
        raise ValueError(f"image {h}x{w} exceeds the canvas {canvas_h}x{canvas_w}")
    out = np.pad(image, ((0, canvas_h - h), (0, canvas_w - w), (0, 0)), mode="edge")
    return np.ascontiguousarray(out), (h, w)


class Transform:
    """Resize to (height, width); with ``train`` the two augmentations, each
    with probability ``AUG_PROB`` from a generator seeded by ``seed``; with
    ``normalize`` f32 ImageNet-normalized out, else u8. HWC out. With
    ``canvas`` (eval only, u8 only) ``(to_canvas(image), (h, w))`` instead."""

    def __init__(self, height: int, width: int, *, train: bool = False,
                 rgb: int = 3, seed: Optional[int] = None, normalize: bool = False,
                 canvas: Optional[Tuple[int, int]] = None):
        if canvas is not None and (train or normalize):
            raise ValueError("canvas mode is eval-only and implies "
                             "normalize=False (device-side standardize)")
        self.height, self.width = height, width
        self.train, self.rgb = train, rgb
        self.rng = np.random.default_rng(seed)
        self.normalize = normalize
        self.canvas = canvas

    def __call__(self, image: np.ndarray):
        if self.canvas is not None:
            return to_canvas(image, *self.canvas)
        image = resize(image, self.height, self.width)
        if self.train:
            if self.rng.random() < AUG_PROB:
                image = shift_scale_rotate(image, self.rng)
            if self.rng.random() < AUG_PROB:
                image = grid_distortion(image, self.rng)
        if self.normalize:
            image = normalize(image, self.rgb)
        if image.ndim == 2:
            image = image[:, :, None]
        return image


def get_train_transforms(height, width, rgb=3, seed=None) -> Transform:
    return Transform(height, width, train=True, rgb=rgb, seed=seed, normalize=True)


def get_valid_transforms(height, width, rgb=3, normalize=False, canvas=None) -> Transform:
    return Transform(height, width, rgb=rgb, normalize=normalize, canvas=canvas)
