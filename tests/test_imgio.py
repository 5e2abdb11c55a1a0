"""Host-side image I/O tests: decode/scale/TIFF round-trips."""

import numpy as np
import pytest

from optflow.core.imgio import (
    ImageReadError,
    pad_to,
    read_float_tiff,
    read_gray,
    read_gray_scaled,
    resize_scale,
    write_float_tiff,
)


def _write_png(path, arr):
    from PIL import Image

    Image.fromarray(arr).save(path)


def test_read_gray_roundtrip(tmp_path, rng):
    arr = rng.integers(0, 255, size=(32, 40), dtype=np.uint8)
    p = tmp_path / "im.png"
    _write_png(str(p), arr)
    out = read_gray(str(p))
    assert out.shape == (32, 40)
    assert np.array_equal(out, arr)


def test_read_gray_missing_raises(tmp_path):
    with pytest.raises(ImageReadError):
        read_gray(str(tmp_path / "nope.png"))


def test_resize_scale_half(rng):
    arr = rng.integers(0, 255, size=(64, 64), dtype=np.uint8)
    out = resize_scale(arr, 0.5)
    assert out.shape == (32, 32)
    assert abs(float(out.mean()) - float(arr.mean())) < 4.0


def test_read_gray_scaled_float(tmp_path, rng):
    arr = rng.integers(0, 255, size=(20, 20), dtype=np.uint8)
    p = tmp_path / "im.png"
    _write_png(str(p), arr)
    out = read_gray_scaled(str(p), 1.0)
    assert out.dtype == np.float32
    assert np.allclose(out, arr)


def test_float_tiff_roundtrip(tmp_path, rng):
    arr = rng.standard_normal((16, 24)).astype(np.float32) * 100
    p = tmp_path / "flow_x.tiff"
    write_float_tiff(str(p), arr)
    out = read_float_tiff(str(p))
    assert out.shape == arr.shape
    assert np.allclose(out, arr, atol=1e-5)


def test_pad_to(rng):
    arr = rng.standard_normal((5, 7)).astype(np.float32)
    out = pad_to(arr, (8, 8))
    assert out.shape == (8, 8)
    assert np.allclose(out[:5, :7], arr)
    assert np.all(out[5:, :] == 0)
