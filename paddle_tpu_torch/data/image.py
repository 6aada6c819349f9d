"""Image transform utilities for reader pipelines: the port of
paddle_tpu/data/image.py, pure numpy and unchanged.

reference: python/paddle/dataset/image.py — resize_short, center/random
crop, flip, to_chw, simple_transform composed inside dataset readers
(the flowers/imagenet pipelines).  The reference shells out to cv2;
zero-dependency numpy equivalents here (bilinear resize) — these run on
the HOST inside reader threads, never inside the step, exactly
like the reference's cv2 calls.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "resize_short", "to_chw", "center_crop", "random_crop",
    "left_right_flip", "simple_transform",
]


def _bilinear_resize(im: np.ndarray, h: int, w: int) -> np.ndarray:
    """HWC (or HW) bilinear resize, numpy only."""
    ih, iw = im.shape[:2]
    if (ih, iw) == (h, w):
        return im
    ys = (np.arange(h) + 0.5) * ih / h - 0.5
    xs = (np.arange(w) + 0.5) * iw / w - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, ih - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, iw - 1)
    y1 = np.clip(y0 + 1, 0, ih - 1)
    x1 = np.clip(x0 + 1, 0, iw - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)
    wx = np.clip(xs - x0, 0.0, 1.0)
    if im.ndim == 3:
        wy = wy[:, None, None]
        wx = wx[None, :, None]
    else:
        wy = wy[:, None]
        wx = wx[None, :]
    arr = im.astype(np.float32)
    ay0, ay1 = arr[y0], arr[y1]
    top = ay0[:, x0] * (1 - wx) + ay0[:, x1] * wx
    bot = ay1[:, x0] * (1 - wx) + ay1[:, x1] * wx
    out = top * (1 - wy) + bot * wy
    if np.issubdtype(im.dtype, np.integer):
        return np.clip(np.rint(out), 0, 255).astype(im.dtype)
    return out.astype(im.dtype)


def resize_short(im: np.ndarray, size: int) -> np.ndarray:
    """Scale so the SHORTER edge becomes `size`
    (reference image.py:197)."""
    h, w = im.shape[:2]
    if h > w:
        return _bilinear_resize(im, int(round(h * size / w)), size)
    return _bilinear_resize(im, size, int(round(w * size / h)))


def to_chw(im: np.ndarray, order=(2, 0, 1)) -> np.ndarray:
    """HWC -> CHW (reference image.py:225)."""
    return im.transpose(order)


def center_crop(im: np.ndarray, size: int, is_color: bool = True):
    h, w = im.shape[:2]
    h_start = (h - size) // 2
    w_start = (w - size) // 2
    return im[h_start:h_start + size, w_start:w_start + size]


def random_crop(im: np.ndarray, size: int, is_color: bool = True,
                rng=None):
    rng = rng or np.random
    h, w = im.shape[:2]
    h_start = int(rng.randint(0, h - size + 1))
    w_start = int(rng.randint(0, w - size + 1))
    return im[h_start:h_start + size, w_start:w_start + size]


def left_right_flip(im: np.ndarray, is_color: bool = True):
    return im[:, ::-1]


def simple_transform(im: np.ndarray, resize_size: int, crop_size: int,
                     is_train: bool, is_color: bool = True, mean=None,
                     rng=None):
    """resize-short + (random crop/flip | center crop) + CHW + mean
    subtract (reference image.py:327)."""
    rng = rng or np.random
    im = resize_short(im, resize_size)
    if is_train:
        im = random_crop(im, crop_size, is_color=is_color, rng=rng)
        if int(rng.randint(2)) == 0:
            im = left_right_flip(im, is_color)
    else:
        im = center_crop(im, crop_size, is_color=is_color)
    if im.ndim == 3:
        im = to_chw(im)
    im = im.astype("float32")
    if mean is not None:
        mean = np.array(mean, dtype=np.float32)
        if mean.ndim == 1 and im.ndim == 3:
            # per-channel mean for CHW images (guard on the ACTUAL
            # rank, not is_color: a grayscale (H, W) image minus a
            # (3,1,1) mean would silently broadcast to a bogus (3,H,W))
            mean = mean[:, np.newaxis, np.newaxis]
        elif mean.ndim == 1 and mean.size > 1 and im.ndim == 2:
            raise ValueError(
                f"per-channel mean of size {mean.size} cannot apply to "
                f"a grayscale image of shape {im.shape}")
        im = im - mean
    return im
