"""PNG and float32 TIFF codec on numpy + zlib alone.

The host I/O prefers cv2 or PIL (core/imgio.py). Where neither is
installed this codec keeps the pipeline whole for the formats the job
path needs:

- PNG read: bit depths 8 and 16, grayscale, gray+alpha, RGB, RGBA and
  8-bit palette images, non-interlaced, all five row filters;
- PNG write: 8-bit and 16-bit grayscale (filter 0, zlib-compressed);
- TIFF read and write: uncompressed single-channel float32 in strips
  (what cv::imwrite of a CV_32FC1 map holds, src/optflow.cpp:482-483).

Anything else raises :class:`CodecError`.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# channels per PNG color type
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


class CodecError(ValueError):
    """The file is not in a format this codec reads."""


# ---------------------------------------------------------------- PNG


def _png_chunks(data: bytes):
    if data[:8] != _PNG_SIG:
        raise CodecError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        ctype = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        if len(body) != length:
            raise CodecError("truncated PNG chunk")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos += 12 + length
    raise CodecError("PNG without IEND")


def _paeth_row(line: np.ndarray, prior: np.ndarray, bpp: int) -> None:
    """In-place Paeth reconstruction of one row (sequential in x)."""
    cur = line.astype(np.int32)
    up = prior.astype(np.int32)
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = up[i]
        c = up[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    line[:] = cur


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    rows = raw.reshape(h, stride + 1)
    filters = rows[:, 0]
    out = rows[:, 1:].copy()
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        line = out[y]
        f = filters[y]
        if f == 1:  # Sub: running sum of each byte lane, mod 256
            for k in range(bpp):
                line[k::bpp] = np.cumsum(line[k::bpp], dtype=np.uint8)
        elif f == 2:  # Up
            line += prior
        elif f == 3:  # Average
            cur = line.astype(np.int32)
            up = prior.astype(np.int32)
            for i in range(stride):
                left = cur[i - bpp] if i >= bpp else 0
                cur[i] = (cur[i] + ((left + up[i]) >> 1)) & 0xFF
            line[:] = cur
        elif f == 4:
            _paeth_row(line, prior, bpp)
        elif f != 0:
            raise CodecError(f"bad PNG filter type {f}")
        prior = line
    return out


def read_png(path: str) -> np.ndarray:
    """Decode a PNG: (H, W) for gray and palette images, (H, W, C)
    otherwise; uint8, or uint16 at bit depth 16 (palettes expanded)."""
    with open(path, "rb") as f:
        data = f.read()
    header = None
    palette = None
    idat = []
    for ctype, body in _png_chunks(data):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
    if header is None:
        raise CodecError("PNG without IHDR")
    w, h, depth, color, _comp, _filt, interlace = header
    if color not in _PNG_CHANNELS or depth not in (8, 16) or interlace:
        raise CodecError(
            f"unsupported PNG (color {color}, depth {depth}, "
            f"interlace {interlace})"
        )
    if color == 3 and (depth != 8 or palette is None):
        raise CodecError("unsupported palette PNG")
    ch = _PNG_CHANNELS[color]
    bpp = ch * depth // 8
    stride = w * bpp
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise CodecError(f"corrupt PNG data: {e}") from e
    if raw.size != h * (stride + 1):
        raise CodecError("PNG data size does not match its header")
    px = _unfilter(raw, h, stride, bpp)
    if depth == 16:
        px = px.view(">u2").astype(np.uint16)
    px = px.reshape(h, w, ch)
    if color == 3:
        return palette[px[..., 0]]
    return px[..., 0] if ch == 1 else px


def write_png(path: str, arr: np.ndarray) -> None:
    """Write a 2-D uint8 or uint16 array as a grayscale PNG."""
    arr = np.asarray(arr)
    if arr.ndim != 2 or arr.dtype not in (np.uint8, np.uint16):
        raise CodecError("write_png takes a 2-D uint8 or uint16 array")
    h, w = arr.shape
    depth = 8 * arr.dtype.itemsize
    rows = np.ascontiguousarray(arr.astype(arr.dtype.newbyteorder(">")))
    raw = np.zeros((h, 1 + rows.nbytes // h), np.uint8)
    raw[:, 1:] = rows.view(np.uint8).reshape(h, -1)

    def chunk(ctype: bytes, body: bytes) -> bytes:
        crc = zlib.crc32(ctype + body) & 0xFFFFFFFF
        return struct.pack(">I", len(body)) + ctype + body + struct.pack(
            ">I", crc
        )

    ihdr = struct.pack(">IIBBBBB", w, h, depth, 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIG)
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))


# ---------------------------------------------------------------- TIFF

_TIFF_TYPES = {3: ("H", 2), 4: ("I", 4)}  # SHORT, LONG


def write_tiff_f32(path: str, arr: np.ndarray) -> None:
    """Write a 2-D array as an uncompressed little-endian float32 TIFF
    (one strip)."""
    arr = np.ascontiguousarray(arr, dtype="<f4")
    if arr.ndim != 2:
        raise CodecError("write_tiff_f32 takes a 2-D array")
    h, w = arr.shape
    tags = [  # (tag, type, value), sorted by tag as TIFF requires
        (256, 4, w),  # ImageWidth
        (257, 4, h),  # ImageLength
        (258, 3, 32),  # BitsPerSample
        (259, 3, 1),  # Compression: none
        (262, 3, 1),  # Photometric: BlackIsZero
        (273, 4, 0),  # StripOffsets (patched below)
        (277, 3, 1),  # SamplesPerPixel
        (278, 4, h),  # RowsPerStrip
        (279, 4, arr.nbytes),  # StripByteCounts
        (284, 3, 1),  # PlanarConfiguration: chunky
        (339, 3, 3),  # SampleFormat: IEEE float
    ]
    ifd_size = 2 + 12 * len(tags) + 4
    data_off = 8 + ifd_size
    ifd = struct.pack("<H", len(tags))
    for tag, typ, val in tags:
        if tag == 273:
            val = data_off
        code, _size = _TIFF_TYPES[typ]
        ifd += struct.pack("<HHI", tag, typ, 1)
        ifd += struct.pack("<" + code, val).ljust(4, b"\0")
    ifd += struct.pack("<I", 0)  # no next IFD
    with open(path, "wb") as f:
        f.write(b"II*\0" + struct.pack("<I", 8))
        f.write(ifd)
        f.write(arr.tobytes())


def read_tiff_f32(path: str) -> np.ndarray:
    """Read the first image of an uncompressed single-channel float32
    TIFF (either byte order, any strip layout)."""
    with open(path, "rb") as f:
        data = f.read()
    order = {b"II": "<", b"MM": ">"}.get(data[:2])
    if order is None or struct.unpack(order + "H", data[2:4])[0] != 42:
        raise CodecError("not a TIFF file")
    (ifd_off,) = struct.unpack(order + "I", data[4:8])
    (n,) = struct.unpack(order + "H", data[ifd_off : ifd_off + 2])
    tags = {}
    for i in range(n):
        e = ifd_off + 2 + 12 * i
        tag, typ, count = struct.unpack(order + "HHI", data[e : e + 8])
        if typ not in _TIFF_TYPES:
            continue
        code, size = _TIFF_TYPES[typ]
        if count * size <= 4:
            vals = struct.unpack(
                order + code * count, data[e + 8 : e + 8 + count * size]
            )
        else:
            (off,) = struct.unpack(order + "I", data[e + 8 : e + 12])
            vals = struct.unpack(
                order + code * count, data[off : off + count * size]
            )
        tags[tag] = vals
    try:
        w, h = tags[256][0], tags[257][0]
        offsets, counts = tags[273], tags[279]
    except KeyError as e:
        raise CodecError(f"TIFF without required tag {e}") from e
    if (
        tags.get(259, (1,))[0] != 1
        or tags.get(258, (0,))[0] != 32
        or tags.get(339, (1,))[0] != 3
        or tags.get(277, (1,))[0] != 1
    ):
        raise CodecError("only uncompressed 1-channel float32 TIFF is read")
    buf = b"".join(data[o : o + c] for o, c in zip(offsets, counts))
    if len(buf) != w * h * 4:
        raise CodecError("TIFF strip data does not match its size")
    return np.frombuffer(buf, order + "f4").astype(np.float32).reshape(h, w)
