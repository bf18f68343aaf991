"""CLIP image preprocessing, byte-equal to the JAX package's PIL path.

``eventgpt_tpu/ops/image.py`` resizes with Pillow's bicubic filter, the
path HF's ``CLIPImageProcessor`` takes. Pillow is not installed beside the
card, so this module carries its own numpy copy of Pillow's 8-bit
resampler (``libImaging/Resample.c``): the bicubic kernel with a = -0.5,
support widened by the scale on a downscale, coefficients normalized per
output pixel and rounded to 22-bit fixed point, a horizontal pass then a
vertical pass, each rounding and clipping to uint8. The rest (center crop,
rescale, normalize) is the same float32 numpy arithmetic as the JAX
package, so pixels come out bit-identical.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Tuple

import numpy as np

# OpenAI CLIP normalization constants (transformers OPENAI_CLIP_MEAN/STD).
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)

_PRECISION_BITS = 32 - 8 - 2
_BICUBIC_SUPPORT = 2.0


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's bicubic convolution kernel with a = -0.5 (float64)."""
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _precompute_coeffs(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per output pixel: the first source index, and the fixed-point
    weights (out_size, ksize), zero past that pixel's tap count."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = _BICUBIC_SUPPORT * filterscale
    ksize = int(math.ceil(support)) * 2 + 1

    center = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    # C's (int) cast truncates toward zero.
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin

    taps = np.arange(ksize)
    live = taps[None, :] < xmax[:, None]
    w = _bicubic((taps[None, :] + xmin[:, None] - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where(live, w, 0.0)
    # Left-to-right running sum, in the order the C loop adds.
    ww = np.zeros(out_size, dtype=np.float64)
    for k in range(ksize):
        ww = ww + w[:, k]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    fixed = w * (1 << _PRECISION_BITS)
    kk = np.trunc(np.where(w < 0, -0.5 + fixed, 0.5 + fixed)).astype(np.int64)
    return xmin, np.where(live, kk, 0)


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One 8-bit resampling pass of a uint8 (H, W, C) image along ``axis``."""
    in_size = img.shape[axis]
    xmin, kk = _precompute_coeffs(in_size, out_size)
    src = img.astype(np.int64)
    acc = np.full(img.shape[:axis] + (out_size,) + img.shape[axis + 1:],
                  1 << (_PRECISION_BITS - 1), dtype=np.int64)
    bshape = [1] * img.ndim
    bshape[axis] = out_size
    for k in range(kk.shape[1]):
        idx = np.minimum(xmin + k, in_size - 1)  # weight is 0 past the taps
        acc += np.take(src, idx, axis=axis) * kk[:, k].reshape(bshape)
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bicubic(img: np.ndarray, new_w: int, new_h: int) -> np.ndarray:
    """uint8 (H, W, C) -> (new_h, new_w, C), as Pillow's
    ``Image.resize((new_w, new_h), BICUBIC)`` computes it."""
    h, w = img.shape[:2]
    out = img
    if new_w != w:
        out = _resample_axis(out, new_w, axis=1)
    if new_h != h:
        out = _resample_axis(out, new_h, axis=0)
    return out


def _resize_shortest_edge(img: np.ndarray, shortest_edge: int) -> np.ndarray:
    """Resize preserving aspect ratio so min(H, W) == shortest_edge; the
    long side becomes ``int(shortest_edge * long / short)`` (floor)."""
    h, w = img.shape[:2]
    short, long = (w, h) if w <= h else (h, w)
    new_short = shortest_edge
    new_long = int(shortest_edge * long / short)
    new_w, new_h = (new_short, new_long) if w <= h else (new_long, new_short)
    return resize_bicubic(img, new_w, new_h)


def _center_crop(arr: np.ndarray, crop: int) -> np.ndarray:
    """Center crop (H, W, C) to (crop, crop, C), zero-padding if smaller.

    Offsets match transformers' ``center_crop`` ((dim - crop) // 2).
    """
    h, w = arr.shape[:2]
    top = (h - crop) // 2
    left = (w - crop) // 2
    if top >= 0 and left >= 0:
        return arr[top : top + crop, left : left + crop]
    out = np.zeros((crop, crop, arr.shape[2]), dtype=arr.dtype)
    dst_top, src_top = max(0, -top), max(0, top)
    dst_left, src_left = max(0, -left), max(0, left)
    hh = min(h, crop)
    ww = min(w, crop)
    out[dst_top : dst_top + hh, dst_left : dst_left + ww] = arr[
        src_top : src_top + hh, src_left : src_left + ww
    ]
    return out


def expand2square(img: np.ndarray, background: Iterable[float] = CLIP_MEAN) -> np.ndarray:
    """Pad an (H, W, C) uint8 image to square, centered, on the CLIP mean:
    LLaVA's ``expand2square`` for ``image_aspect_ratio='square'``. The
    background channels are ``int(mean * 255)`` (floor, as LLaVA computes
    them) and the image sits at ``(side - dim) // 2``."""
    h, w = img.shape[:2]
    if h == w:
        return img
    side = max(h, w)
    bg = np.array([int(c * 255) for c in background], dtype=img.dtype)
    out = np.full((side, side, img.shape[2]), bg, dtype=img.dtype)
    top = (side - h) // 2
    left = (side - w) // 2
    out[top:top + h, left:left + w] = img
    return out


def clip_preprocess(frame: np.ndarray, image_size: int = 336) -> np.ndarray:
    """uint8 RGB (H, W, 3) -> normalized float32 CHW (3, S, S): bicubic
    shortest-edge resize, center crop, rescale by 1/255, CLIP normalize."""
    img = _resize_shortest_edge(np.ascontiguousarray(frame, dtype=np.uint8), image_size)
    arr = np.asarray(img, dtype=np.float32)
    arr = _center_crop(arr, image_size)
    arr = arr / 255.0
    arr = (arr - CLIP_MEAN) / CLIP_STD
    return np.transpose(arr, (2, 0, 1))


def clip_preprocess_batch(frames: Iterable[np.ndarray], image_size: int = 336) -> np.ndarray:
    """Preprocess a list of frames -> (N, 3, S, S) float32."""
    return np.stack([clip_preprocess(f, image_size) for f in frames])


def clip_normalize(frames):
    """uint8 NHWC frames on a device, already at the target size (the
    device rasterizer's output) -> normalized float32 NCHW on the same
    device: rescale by 1/255, CLIP mean and std."""
    import torch

    mean = torch.as_tensor(CLIP_MEAN, device=frames.device)
    std = torch.as_tensor(CLIP_STD, device=frames.device)
    x = frames.to(torch.float32) / 255.0
    x = (x - mean) / std
    return x.permute(0, 3, 1, 2)


def process_event_file(
    path: str,
    n_frames: int = 5,
    image_size: int = 336,
) -> Tuple[List[int], np.ndarray]:
    """npy path -> (event_image_size, (n_frames, 3, S, S) float32 pixels):
    load, guard the 100 ms span, equal-count split, rasterize, CLIP
    preprocess. ``event_image_size`` is the (H, W) of the first frame."""
    from eventgpt_tpu_torch.ops.raster import events_to_frames, load_event_npy

    events = load_event_npy(path)
    frames = events_to_frames(events, n_frames=n_frames)
    event_image_size = list(frames[0].shape[:2])
    return event_image_size, clip_preprocess_batch(frames, image_size)
