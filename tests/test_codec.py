"""The numpy + zlib PNG/TIFF codec against PIL, and imgio's fallback to
it when neither cv2 nor PIL is installed."""

import numpy as np
import pytest
from PIL import Image

from optflow.core import codec, imgio


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_png_written_by_codec_reads_in_pil(tmp_path, rng, dtype):
    hi = np.iinfo(dtype).max
    arr = rng.integers(0, hi, size=(23, 37), endpoint=True).astype(dtype)
    p = str(tmp_path / "a.png")
    codec.write_png(p, arr)
    with Image.open(p) as im:
        back = np.asarray(im)
    assert np.array_equal(back.astype(dtype), arr)
    assert np.array_equal(codec.read_png(p), arr)


@pytest.mark.parametrize("mode", ["L", "I;16", "RGB", "RGBA", "LA", "P"])
def test_png_written_by_pil_reads_in_codec(tmp_path, rng, mode):
    """PIL writes adaptive row filters (Sub/Up/Average/Paeth), so this
    covers every unfilter branch as well as each color type."""
    base = rng.integers(0, 255, size=(19, 33, 3), dtype=np.uint8)
    # smooth content makes the encoder pick predictive filters
    base = (base // 8 + np.arange(33, dtype=np.uint8)[None, :, None] * 7)
    rgb = Image.fromarray(base, "RGB")
    if mode == "I;16":
        arr16 = (base[..., 0].astype(np.uint16) * 257 + 3)
        im = Image.fromarray(arr16)
    elif mode == "P":
        im = rgb.convert("P", palette=Image.ADAPTIVE, colors=64)
    else:
        im = rgb.convert(mode)
    p = str(tmp_path / f"{mode.replace(';', '')}.png")
    im.save(p)
    with Image.open(p) as ref_im:
        if mode == "P":
            ref = np.asarray(ref_im.convert("RGB"))
        else:
            ref = np.asarray(ref_im)
    got = codec.read_png(p)
    assert np.array_equal(got, ref.astype(got.dtype))


def test_tiff_f32_roundtrip_against_pil(tmp_path, rng):
    arr = (rng.standard_normal((17, 29)) * 300).astype(np.float32)
    p = str(tmp_path / "a.tiff")
    codec.write_tiff_f32(p, arr)
    with Image.open(p) as im:
        assert np.array_equal(np.asarray(im, dtype=np.float32), arr)
    q = str(tmp_path / "b.tiff")
    Image.fromarray(arr, mode="F").save(q)
    assert np.array_equal(codec.read_tiff_f32(q), arr)


def test_codec_rejects_other_formats(tmp_path, rng):
    p = str(tmp_path / "x.jpg")
    Image.fromarray(rng.integers(0, 255, (8, 8), dtype=np.uint8)).save(p)
    with pytest.raises(codec.CodecError):
        codec.read_png(p)
    with pytest.raises(codec.CodecError):
        codec.read_tiff_f32(p)


def test_imgio_without_cv2_or_pil(tmp_path, rng, monkeypatch):
    """With the numpy codec as the decoder, the job path's host I/O still
    reads PNG sections, scales them like the native loader and writes
    float TIFF maps."""
    monkeypatch.setattr(imgio, "python_decoder", lambda: "numpy")
    arr = rng.integers(0, 255, size=(32, 48), dtype=np.uint8)
    p = str(tmp_path / "s.png")
    imgio.write_png(p, arr)
    assert np.array_equal(imgio.read_gray(p), arr)
    half = imgio.read_gray_scaled(p, 0.5)
    # half-pixel bilinear at exactly 0.5 is the 2x2 block mean
    blocks = arr.reshape(16, 2, 24, 2).astype(np.float32).mean(axis=(1, 3))
    assert half.dtype == np.float32
    assert np.allclose(half, blocks, atol=1e-4)
    t = str(tmp_path / "f_x.tiff")
    flow = rng.standard_normal((16, 24)).astype(np.float32)
    imgio.write_float_tiff(t, flow)
    assert np.array_equal(imgio.read_float_tiff(t), flow)
    with pytest.raises(imgio.ImageReadError):
        imgio.read_gray(str(tmp_path / "missing.png"))


def test_gray_conversion_matches_pil_luma(tmp_path, rng):
    """RGB and 16-bit PNGs reduce to 8-bit gray like IMREAD_GRAYSCALE:
    BT.601 luma (within one level of PIL's integer rounding) and the high
    byte of 16-bit samples."""
    rgb = rng.integers(0, 255, size=(12, 20, 3), dtype=np.uint8)
    p = str(tmp_path / "c.png")
    Image.fromarray(rgb, "RGB").save(p)
    ref = np.asarray(Image.fromarray(rgb, "RGB").convert("L"), np.int32)
    got = imgio._to_gray8(codec.read_png(p)).astype(np.int32)
    assert np.abs(got - ref).max() <= 1
    a16 = rng.integers(0, 65535, size=(6, 7), dtype=np.uint16)
    q = str(tmp_path / "d.png")
    codec.write_png(q, a16)
    assert np.array_equal(imgio._to_gray8(codec.read_png(q)), a16 >> 8)


def _encode_rows(px: np.ndarray, ftype: int, bpp: int) -> bytes:
    """Reference PNG row filter (spec section 9.2), one filter type for
    every row, written byte by byte."""
    out = []
    prior = [0] * px.shape[1]
    for row in px.astype(int).tolist():
        enc = []
        for i, x in enumerate(row):
            a = row[i - bpp] if i >= bpp else 0
            b = prior[i]
            c = prior[i - bpp] if i >= bpp else 0
            if ftype == 0:
                pred = 0
            elif ftype == 1:
                pred = a
            elif ftype == 2:
                pred = b
            elif ftype == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            enc.append((x - pred) % 256)
        out.append(bytes([ftype] + enc))
        prior = row
    return b"".join(out)


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_png_unfilter_each_filter_type(tmp_path, rng, ftype):
    import struct
    import zlib

    h, w = 9, 14
    gray16 = rng.integers(0, 65535, size=(h, w), dtype=np.uint16)
    raw = gray16.astype(">u2").view(np.uint8).reshape(h, 2 * w)

    def chunk(t, body):
        return (struct.pack(">I", len(body)) + t + body
                + struct.pack(">I", zlib.crc32(t + body) & 0xFFFFFFFF))

    p = str(tmp_path / f"f{ftype}.png")
    with open(p, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 0, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(_encode_rows(raw, ftype, 2))))
        f.write(chunk(b"IEND", b""))
    assert np.array_equal(codec.read_png(p), gray16)
    with Image.open(p) as im:
        assert np.array_equal(np.asarray(im).astype(np.uint16), gray16)
