"""PNG decoding and bilinear resizing on the host, in numpy and zlib.

The JAX package reads RHD's PNGs and resizes its crops with cv2 (JAX
data/datasets/rhd.py:44-50,127-128); the port carries both itself, so that
its RHD path needs neither cv2 nor PIL:

  * `read_png`: 8- and 16-bit, non-interlaced PNGs of colour type 0 (grey,
    (H, W)), 2 (RGB, (H, W, 3)) and 6 (RGBA, (H, W, 4)), with all five row
    filters, as uint8 or uint16.  Colour comes back in the file's order,
    RGB(A): what the JAX `_read` returns after flipping cv2's BGR.
  * `resize_bilinear`: cv2.resize(..., INTER_LINEAR) on float images: pixel
    centres at (i + 0.5) scale - 0.5, the coordinates clamped at both edges.

`write_png` is the inverse of `read_png` (uint8, or uint16 grey), with the
row filters chosen by the caller: it writes the fake RHD trees of the
tests and of chip_smoke.py, the visualization's frames and 16-bit depth
maps.  `read_pgm` reads binary (P5) and text (P2) PGMs, `read_tiff`
uncompressed baseline TIFFs (utils/depth_io.py).  tests/test_torch_rhd.py holds the reader and the resize to
cv2.
"""

from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> samples per pixel


def _unfilter(pix: np.ndarray, filters: np.ndarray) -> np.ndarray:
    """Undo the PNG row filters of (H, W, bpp) filtered bytes.  Average and
    Paeth predict from the left byte as it is being decoded, so the image
    is decoded one anti-diagonal of pixels at a time: a pixel needs only
    its left, upper and upper-left neighbours, which lie on earlier
    diagonals.  The image is held skewed, pixel (y, x) at
    Z[y + 1, y + x + 2], so that a diagonal is a column of Z, its left
    neighbours the column before, and its upper and upper-left neighbours
    that column and the one before it one row up; row 0 and the columns
    left of each row stay 0, as the filters read them."""
    H, W, bpp = pix.shape
    if not np.isin(filters, (0, 1, 2, 3, 4)).all():
        raise ValueError(f"PNG: unknown filter types {sorted(set(filters.tolist()))}")
    Z = np.zeros((H + 1, H + W + 2, bpp), np.int16)
    F = np.zeros((H, H + W, bpp), np.int16)
    for y in range(H):
        F[y, y:y + W] = pix[y]
    kind = filters.astype(np.int16)[:, None]
    for d in range(H + W - 1):
        lo, hi = max(0, d - W + 1), min(H, d + 1)
        a, b, c = Z[lo + 1:hi + 1, d + 1], Z[lo:hi, d + 1], Z[lo:hi, d]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        f = kind[lo:hi]
        pred = np.where(f == 4, paeth, np.where(f == 3, (a + b) >> 1,
                                                np.where(f == 2, b, np.where(f == 1, a, 0))))
        Z[lo + 1:hi + 1, d + 2] = (F[lo:hi, d] + pred) & 255
    return np.stack([Z[y + 1, y + 2:y + 2 + W] for y in range(H)]).astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """An 8- or 16-bit non-interlaced PNG as uint8 or uint16: (H, W) grey,
    (H, W, 3) RGB or (H, W, 4) RGBA.  Raises ValueError on anything else."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length  # length, type, body, CRC
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, colour, _, _, interlace = header
    if depth not in (8, 16) or colour not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: bit depth {depth}, colour type {colour}, interlace "
                         f"{interlace}; read_png takes 8- and 16-bit non-interlaced PNGs of "
                         f"colour type 0, 2 or 6")
    channels, size = _CHANNELS[colour], depth // 8
    bpp = channels * size  # bytes a pixel: the filters' left distance
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows.reshape(height, 1 + width * bpp)
    img = _unfilter(rows[:, 1:].reshape(height, width, bpp), rows[:, 0])
    if size == 2:  # big-endian samples
        img = img.reshape(height, width, channels, 2).astype(np.uint16)
        img = (img[..., 0] << 8) | img[..., 1]
    return img.reshape(height, width) if channels == 1 else img


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray, filters=(0,)) -> None:
    """Write a uint8 (H, W) grey, (H, W, 3) RGB or (H, W, 4) RGBA image,
    or a uint16 (H, W) grey one, as a PNG whose row y is filtered with
    filters[y % len(filters)]."""
    sixteen = np.asarray(img).dtype == np.uint16
    if sixteen:
        if np.ndim(img) != 2:
            raise ValueError("write_png: 16-bit images must be grey (H, W)")
        img = np.asarray(img).astype(">u2")
        H, W = img.shape
        colour, bpp = 0, 2
        x = img.view(np.uint8).reshape(H, W, 2).astype(np.int16)
    else:
        img = np.ascontiguousarray(img, np.uint8)
        H, W = img.shape[:2]
        bpp = 1 if img.ndim == 2 else img.shape[2]
        colour = {v: k for k, v in _CHANNELS.items()}[bpp]
        x = img.reshape(H, W, bpp).astype(np.int16)
    left = np.zeros_like(x)
    left[:, 1:] = x[:, :-1]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[1:, 1:] = x[:-1, :-1]
    pa, pb, pc = np.abs(up - upleft), np.abs(left - upleft), np.abs(left + up - 2 * upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    preds = (np.zeros_like(x), left, up, (left + up) >> 1, paeth)
    kinds = np.array([filters[y % len(filters)] for y in range(H)], np.uint8)
    rows = np.empty((H, 1 + W * bpp), np.uint8)
    rows[:, 0] = kinds
    for y, f in enumerate(kinds):
        rows[y, 1:] = ((x[y] - preds[f][y]) & 255).reshape(-1)
    header = struct.pack(">IIBBBBB", W, H, 16 if sixteen else 8, colour, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def read_pgm(path: str) -> np.ndarray:
    """A PGM, binary (P5) or text (P2), as (H, W) uint8 where its maxval is
    below 256, else uint16; the samples as they are stored, not scaled."""
    with open(path, "rb") as f:
        data = f.read()
    fields, pos = [], 0
    while len(fields) < 4:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos) + 1
            continue
        end = pos
        while end < len(data) and not data[end:end + 1].isspace() and data[end:end + 1] != b"#":
            end += 1
        fields.append(data[pos:end])
        pos = end
    magic, (W, H, maxval) = fields[0], map(int, fields[1:])
    if magic not in (b"P5", b"P2"):
        raise ValueError(f"{path}: not a PGM (magic {magic!r})")
    dtype = np.uint8 if maxval < 256 else np.uint16
    if magic == b"P2":
        return np.array(data[pos:].split()[:W * H], np.int64).astype(dtype).reshape(H, W)
    raw = data[pos + 1:]  # one whitespace byte ends the header
    return np.frombuffer(raw, ">u2" if dtype == np.uint16 else np.uint8,
                         count=W * H).astype(dtype).reshape(H, W)


_TIFF_COMPRESSION = {1: "none", 2: "CCITT RLE", 3: "CCITT fax 3", 4: "CCITT fax 4", 5: "LZW",
                     6: "old JPEG", 7: "JPEG", 8: "Deflate", 32773: "PackBits",
                     32946: "Deflate"}
_TIFF_TYPES = {1: "B", 3: "H", 4: "I", 16: "Q"}


def read_tiff(path: str) -> np.ndarray:
    """An uncompressed baseline TIFF (its first image; chunky samples of 8,
    16, 32 or 64 bits, unsigned, signed or float, in strips) as (H, W) or
    (H, W, samples).  A compressed one raises ValueError naming its
    compression."""
    with open(path, "rb") as f:
        data = f.read()
    order = {b"II": "<", b"MM": ">"}.get(data[:2])
    if order is None or struct.unpack(order + "H", data[2:4])[0] != 42:
        raise ValueError(f"{path}: not a TIFF file")
    ifd = struct.unpack(order + "I", data[4:8])[0]
    n = struct.unpack(order + "H", data[ifd:ifd + 2])[0]
    tags = {}
    for i in range(n):
        tag, kind, count, value = struct.unpack(order + "HHI4s",
                                                data[ifd + 2 + 12 * i:ifd + 14 + 12 * i])
        code = _TIFF_TYPES.get(kind)
        if code is None:
            continue
        size = struct.calcsize(code) * count
        raw = value if size <= 4 else data[struct.unpack(order + "I", value)[0]:][:size]
        tags[tag] = struct.unpack(order + code * count, raw[:size])
    compression = tags.get(259, (1,))[0]
    if compression != 1:
        raise ValueError(f"{path}: a TIFF compressed with "
                         f"{_TIFF_COMPRESSION.get(compression, f'scheme {compression}')} "
                         f"(compression {compression}); read_tiff reads uncompressed TIFFs")
    if tags.get(284, (1,))[0] != 1:
        raise ValueError(f"{path}: planar TIFF samples; read_tiff reads chunky ones")
    W, H = tags[256][0], tags[257][0]
    samples = tags.get(277, (1,))[0]
    bits = tags.get(258, (1,))[0]
    fmt = {1: "u", 2: "i", 3: "f"}[tags.get(339, (1,))[0]]
    dtype = np.dtype(f"{order}{fmt}{bits // 8}")
    body = b"".join(data[o:o + c] for o, c in zip(tags[273], tags[279]))
    img = np.frombuffer(body, dtype, count=W * H * samples).astype(dtype.newbyteorder("="))
    return img.reshape(H, W) if samples == 1 else img.reshape(H, W, samples)


def _taps(n_out: int, n_in: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """cv2's INTER_LINEAR taps along one axis: (first index, second index,
    weight of the second)."""
    f = ((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s
    low, high = s < 0, s >= n_in - 1
    s[low], f[low] = 0, 0.0
    s[high], f[high] = n_in - 1, 0.0
    return s, np.minimum(s + 1, n_in - 1), f.astype(np.float32)


def resize_bilinear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """cv2.resize(img, size, interpolation=cv2.INTER_LINEAR) for a float
    (H, W[, C]) image; `size` is (width, height) as cv2 takes it.  Returns
    float32."""
    width, height = size
    img = np.asarray(img, np.float32)
    x0, x1, fx = _taps(width, img.shape[1])
    y0, y1, fy = _taps(height, img.shape[0])
    if img.ndim == 3:
        fx, fy = fx[:, None], fy[:, None]
    rows = img[:, x0] * (1.0 - fx) + img[:, x1] * fx  # horizontal pass first, as cv2
    fy = fy[:, None]
    return rows[y0] * (1.0 - fy) + rows[y1] * fy
