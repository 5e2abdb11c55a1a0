"""Host-side image I/O: grayscale decode, scaling, float TIFF read/write.

The reference decodes on the CPU with ``cv::imread(IMREAD_GRAYSCALE)`` and
scales with ``cv::resize`` (src/optflow.cpp:106-125) before uploading to the
GPU; flow/map outputs are written as one float32 TIFF per component
(src/optflow.cpp:478-484). Here decode/resize stay on the host and the
device side consumes float32 arrays in the 0..255 intensity range (OpenCV
convention, no normalization).

The decoder is the first of cv2, PIL and the numpy + zlib codec
(core/codec.py) that is installed; :func:`python_decoder` names it. cv2
and PIL are imported on first use, so a host with neither still runs
PNG sections and float TIFF outputs.
"""

from __future__ import annotations

import functools
import os
from typing import Tuple

import numpy as np

from optflow.core import codec


class ImageReadError(RuntimeError):
    """Raised when an image fails to decode (bad/missing file).

    The reference logs and skips the pair (src/optflow.cpp:108-112,120-124);
    the engine catches this and does the same.
    """


@functools.lru_cache(maxsize=1)
def python_decoder() -> str:
    """Name of the Python-side decoder in use: "cv2", "PIL" or "numpy"."""
    for name, module in (("cv2", "cv2"), ("PIL", "PIL.Image")):
        try:
            __import__(module)
            return name
        except ImportError:
            continue
    return "numpy"


def _to_gray8(px: np.ndarray) -> np.ndarray:
    """IMREAD_GRAYSCALE semantics for a decoded PNG: 16-bit keeps its high
    byte, color drops alpha and takes BT.601 luma."""
    if px.dtype == np.uint16:
        px = (px >> 8).astype(np.uint8)
    if px.ndim == 3:
        if px.shape[2] in (2, 4):
            px = px[..., :-1]
        if px.shape[2] == 3:
            luma = px.astype(np.float32) @ np.array(
                [0.299, 0.587, 0.114], np.float32
            )
            px = np.clip(np.rint(luma), 0, 255).astype(np.uint8)
        else:
            px = px[..., 0]
    return px


def read_gray(path: str) -> np.ndarray:
    """Read an image as uint8 grayscale (ref: cv::imread IMREAD_GRAYSCALE)."""
    decoder = python_decoder()
    if decoder == "cv2":
        import cv2

        im = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        if im is None or im.size == 0:
            raise ImageReadError(path)
        return im
    if decoder == "PIL":
        from PIL import Image

        try:
            with Image.open(path) as pim:
                return np.asarray(pim.convert("L"))
        except (OSError, ValueError) as e:
            raise ImageReadError(path) from e
    try:
        return _to_gray8(codec.read_png(path))
    except (OSError, codec.CodecError) as e:
        raise ImageReadError(path) from e


def _resize_bilinear_np(im: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """Half-pixel bilinear resample without antialiasing, as the native
    loader computes it (float32 out, no rounding)."""
    src = im.astype(np.float32)
    h, w = src.shape

    def taps(n_out, n_in):
        f = (np.arange(n_out, dtype=np.float32) + 0.5) * (n_in / n_out) - 0.5
        f = np.clip(f, 0.0, n_in - 1.0)
        i0 = np.minimum(f.astype(np.int64), max(n_in - 2, 0))
        return i0, np.minimum(i0 + 1, n_in - 1), (f - i0).astype(np.float32)

    y0, y1, wy = taps(nh, h)
    x0, x1, wx = taps(nw, w)
    top = src[y0][:, x0] + wx * (src[y0][:, x1] - src[y0][:, x0])
    bot = src[y1][:, x0] + wx * (src[y1][:, x1] - src[y1][:, x0])
    return top + wy[:, None] * (bot - top)


def resize_scale(im: np.ndarray, scale: float) -> np.ndarray:
    """Uniform rescale with bilinear sampling (ref: cv::resize default
    INTER_LINEAR, src/optflow.cpp:113,125). ``scale == 1`` is a no-op."""
    if scale == 1:
        return im
    decoder = python_decoder()
    if decoder == "cv2":
        import cv2

        return cv2.resize(im, None, fx=scale, fy=scale)
    h, w = im.shape[:2]
    new_w = int(round(w * scale))
    new_h = int(round(h * scale))
    if decoder == "PIL":
        from PIL import Image

        with Image.fromarray(im) as pim:
            return np.asarray(pim.resize((new_w, new_h), Image.BILINEAR))
    return _resize_bilinear_np(im, new_h, new_w)


def read_gray_scaled(path: str, scale: float) -> np.ndarray:
    """Decode + rescale, returned as float32 (0..255)."""
    return resize_scale(read_gray(path), scale).astype(np.float32)


def write_float_tiff(path: str, arr: np.ndarray) -> None:
    """Write a float32 single-channel TIFF (ref: cv::imwrite of CV_32FC1,
    src/optflow.cpp:482-483)."""
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    decoder = python_decoder()
    if decoder == "cv2":
        import cv2

        if not cv2.imwrite(path, arr):
            raise OSError(f"failed to write {path}")
    elif decoder == "PIL":
        from PIL import Image

        Image.fromarray(arr, mode="F").save(path)
    else:
        codec.write_tiff_f32(path, arr)


def write_png(path: str, arr: np.ndarray) -> None:
    """Write a 2-D uint8 or uint16 array as a grayscale PNG."""
    decoder = python_decoder()
    if decoder == "cv2":
        import cv2

        if not cv2.imwrite(path, np.ascontiguousarray(arr)):
            raise OSError(f"failed to write {path}")
    elif decoder == "PIL":
        from PIL import Image

        Image.fromarray(np.ascontiguousarray(arr)).save(path)
    else:
        codec.write_png(path, arr)


def read_float_tiff(path: str) -> np.ndarray:
    """Read a float32 TIFF written by :func:`write_float_tiff` (or the
    reference binary)."""
    decoder = python_decoder()
    if decoder == "cv2":
        import cv2

        arr = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if arr is None:
            raise ImageReadError(path)
        return arr.astype(np.float32)
    if decoder == "PIL":
        from PIL import Image

        with Image.open(path) as pim:
            return np.asarray(pim, dtype=np.float32)
    try:
        return codec.read_tiff_f32(path)
    except (OSError, codec.CodecError) as e:
        raise ImageReadError(path) from e


def pad_to(im: np.ndarray, shape: Tuple[int, int], fill: float = 0.0) -> np.ndarray:
    """Zero-pad an image up to ``shape`` (static-shape bucketing helper).

    Padding with 0 composes with the reference's <=1.0-intensity background
    masking (src/optflow.cpp:467-473): padded pixels are masked out exactly
    like resin background.
    """
    h, w = im.shape[:2]
    th, tw = shape
    if h == th and w == tw:
        return im
    out = np.full((th, tw), fill, dtype=im.dtype)
    out[:h, :w] = im
    return out
