"""Image I/O: PPM, Radiance HDR, BMP and PNG to and from numpy
(counterpart of `fovtrace/scene/image_io.py`).

Every loader returns what the reference's returns for the same bytes.
PNG rows are unfiltered by the host library `native.png_unfilter`: the
Sub, Average and Paeth filters predict each byte from the decoded byte
to its left, which the reference decodes one byte at a time in Python.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _to_u8(img) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img
    return np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)


# ------------------------------------------------------------------- PPM
def load_ppm(path: str) -> np.ndarray:
    """Load P3/P6 PPM -> float32 [H,W,3] in [0,1]."""
    with open(path, "rb") as f:
        data = f.read()
    tokens = []
    i = 0
    # the header's four tokens, skipping comments
    while len(tokens) < 4:
        while i < len(data) and data[i:i + 1].isspace():
            i += 1
        if data[i:i + 1] == b"#":
            while i < len(data) and data[i:i + 1] != b"\n":
                i += 1
            continue
        j = i
        while j < len(data) and not data[j:j + 1].isspace():
            j += 1
        tokens.append(data[i:j])
        i = j
    i += 1  # the single whitespace after maxval
    magic = tokens[0]
    w, h, maxval = int(tokens[1]), int(tokens[2]), int(tokens[3])
    if magic == b"P6":
        dtype = np.uint8 if maxval < 256 else ">u2"
        img = np.frombuffer(data, dtype=dtype, count=w * h * 3, offset=i)
        return img.reshape(h, w, 3).astype(np.float32) / maxval
    if magic == b"P3":
        vals = np.array(data[i:].split(), dtype=np.float32)[:w * h * 3]
        return vals.reshape(h, w, 3) / maxval
    raise ValueError(f"unsupported PPM magic {magic!r}")


def save_ppm(path: str, img: np.ndarray) -> None:
    """img: [H,W,3] float in [0,1] or uint8 in [0,255]."""
    img8 = _to_u8(img)
    h, w = img8.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(img8).tobytes())


# ------------------------------------------------------------------- HDR
def load_hdr(path: str) -> np.ndarray:
    """Load Radiance RGBE (.hdr, flat or RLE scanlines) -> float32
    [H,W,3] linear radiance."""
    with open(path, "rb") as f:
        if not f.readline().strip().startswith(b"#?"):
            raise ValueError("not a Radiance HDR file")
        while f.readline().strip() != b"":
            pass
        dims = f.readline().split()     # -Y H +X W
        h, w = int(dims[1]), int(dims[3])
        data = f.read()

    rgbe = np.zeros((h, w, 4), np.uint8)
    pos = 0
    for y in range(h):
        if pos + 4 <= len(data) and data[pos] == 2 and data[pos + 1] == 2:
            pos += 4    # RLE scanline: each channel in runs and literals
            for c in range(4):
                x = 0
                while x < w:
                    cnt = data[pos]
                    pos += 1
                    if cnt > 128:
                        rgbe[y, x:x + cnt - 128, c] = data[pos]
                        pos += 1
                        x += cnt - 128
                    else:
                        rgbe[y, x:x + cnt, c] = np.frombuffer(data, np.uint8,
                                                              cnt, pos)
                        pos += cnt
                        x += cnt
        else:
            rgbe[y] = np.frombuffer(data, np.uint8, w * 4, pos).reshape(w, 4)
            pos += w * 4
    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp > 0, np.ldexp(1.0, exp - 136), 0.0).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


def _rle_channel(out: bytearray, c: np.ndarray) -> None:
    """One channel of a scanline in runs (4 or more equal bytes, at most
    127 a run) and literals (at most 128 bytes)."""
    def literal(a):
        for i in range(0, a.size, 128):
            out.append(min(128, a.size - i))
            out.extend(a[i:i + 128].tobytes())

    starts = np.flatnonzero(np.r_[True, c[1:] != c[:-1]])
    lens = np.diff(np.r_[starts, c.size])
    lit = 0
    for s, n in zip(starts[lens >= 4], lens[lens >= 4]):
        literal(c[lit:s])
        for k in range(0, n, 127):
            out.extend((128 + min(127, n - k), c[s]))
        lit = s + n
    literal(c[lit:])


def save_hdr(path: str, img: np.ndarray) -> None:
    """img: [H,W,3] float linear radiance -> Radiance RGBE (.hdr), in RLE
    scanlines where the format allows them (widths 8 to 32767), flat
    otherwise."""
    img = np.maximum(np.asarray(img, np.float32), 0.0)
    h, w = img.shape[:2]
    m = img.max(axis=-1)
    mant, ex = np.frexp(m)
    ok = m > 1e-32
    scale = np.where(ok, mant * 256.0 / np.where(ok, m, 1.0), 0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(ok, ex + 128, 0)
    out = bytearray(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
    out += b"-Y %d +X %d\n" % (h, w)
    if not 8 <= w <= 32767:
        out += rgbe.tobytes()
    else:
        for y in range(h):
            out += bytes((2, 2, w >> 8, w & 255))
            for c in range(4):
                _rle_channel(out, rgbe[y, :, c])
    with open(path, "wb") as f:
        f.write(out)


# ------------------------------------------------------------------- BMP
def save_bmp(path: str, img: np.ndarray) -> None:
    """24-bit BMP: bottom-up BGR rows padded to 4 bytes.
    img: [H,W,3] float in [0,1] or uint8 in [0,255]."""
    img8 = _to_u8(img)
    h, w = img8.shape[:2]
    row_size = (w * 3 + 3) & ~3
    rows = np.zeros((h, row_size), np.uint8)
    rows[:, :w * 3] = img8[::-1, :, 2::-1].reshape(h, w * 3)
    pixel_bytes = rows.tobytes()
    header = struct.pack("<2sIHHI", b"BM", 54 + len(pixel_bytes), 0, 0, 54)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, len(pixel_bytes),
                       2835, 2835, 0, 0)
    with open(path, "wb") as f:
        f.write(header + info + pixel_bytes)


def load_bmp(path: str) -> np.ndarray:
    """24-bit BMP (bottom-up, or top-down for a negative height) ->
    float32 [H,W,3] in [0,1]."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"BM":
        raise ValueError("not a BMP file")
    offset = struct.unpack("<I", data[10:14])[0]
    w, h = struct.unpack("<ii", data[18:26])
    bpp = struct.unpack("<H", data[28:30])[0]
    if bpp != 24:
        raise ValueError(f"only 24-bit BMP supported, got {bpp}")
    row_size = (w * 3 + 3) & ~3
    rows = np.frombuffer(data, np.uint8, abs(h) * row_size, offset)
    img = rows.reshape(abs(h), row_size)[:, :w * 3].reshape(abs(h), w, 3)
    img = img[:, :, ::-1]
    if h > 0:
        img = img[::-1]
    return img.astype(np.float32) / 255.0


# ------------------------------------------------------------------- PNG
_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def load_png(path: str) -> np.ndarray:
    """Baseline PNG -> float32 [H,W,3] in [0,1]: 8- and 16-bit gray,
    gray + alpha, RGB and RGBA, and 8-bit palette; not interlaced.
    Alpha is dropped."""
    from fovtrace_torch import native

    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_MAGIC:
        raise ValueError("not a PNG file")
    pos = 8
    idat = []
    palette = None
    w = h = bitdepth = color_type = interlace = None
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        chunk = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            w, h, bitdepth, color_type, _, _, interlace = struct.unpack(
                ">IIBBBBB", chunk)
        elif ctype == b"PLTE":
            palette = np.frombuffer(chunk, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(chunk)
        elif ctype == b"IEND":
            break
    if interlace:
        raise ValueError("interlaced PNG not supported")
    if color_type == 3 and bitdepth != 8:
        raise ValueError("palette PNG with sub-byte depth not supported")
    if bitdepth not in (8, 16):
        raise ValueError(f"unsupported PNG bit depth {bitdepth}")
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]

    bypp = channels * (bitdepth // 8)
    out = native.png_unfilter(zlib.decompress(b"".join(idat)), h, w * bypp,
                              bypp)
    if bitdepth == 16:
        img = out.reshape(h, w, channels, 2)
        img = (img[..., 0].astype(np.float32) * 256
               + img[..., 1]).astype(np.float32) / 65535.0
    else:
        img = out.reshape(h, w, channels).astype(np.float32) / 255.0
    if color_type == 3:
        idx = (img[..., 0] * 255.0 + 0.5).astype(np.int32)
        return palette[np.clip(idx, 0, len(palette) - 1)].astype(
            np.float32) / 255.0
    if channels in (1, 2):
        return np.repeat(img[..., :1], 3, axis=-1)
    return img[..., :3]


def save_png(path: str, img: np.ndarray) -> None:
    """8-bit RGB PNG: unfiltered rows in one IDAT chunk."""
    img = _to_u8(img)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    h, w = img.shape[:2]
    rows = np.zeros((h, 1 + w * 3), np.uint8)
    rows[:, 1:] = img[:, :, :3].reshape(h, w * 3)

    def chunk(ctype: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + ctype + payload
                + struct.pack(">I", zlib.crc32(ctype + payload) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_MAGIC + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + chunk(b"IEND", b""))
