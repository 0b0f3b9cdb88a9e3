"""Baseline JPEG decoding and encoding on the host, in numpy.

The JAX package reads H36M's frames with cv2 (JAX
data/datasets/joints_dataset.py:123-140, utils/zipreader.py), whose
libjpeg-turbo decodes them; the port decodes them itself, so that its H36M
path needs neither cv2 nor PIL:

  * `read_jpeg`: baseline sequential JPEGs (SOF0, 8-bit samples, Huffman
    coding): one component (grey, replicated to three as cv2's
    IMREAD_COLOR does) or three (YCbCr) at any sampling the file declares,
    interleaved or not, with restart intervals, at any size.  Returns
    (H, W, 3) uint8 BGR, bit for bit what cv2.imread / cv2.imdecode
    (IMREAD_COLOR) give.  The Huffman decode is serial and runs in Python
    over 16-bit lookup tables; everything after it is numpy over all blocks
    at once, computed as libjpeg-turbo computes it: the ISLOW integer IDCT
    (jidctint.c), the fancy triangle upsampling (jdsample.c; box
    replication where libjpeg-turbo takes it) and the fixed-point
    YCbCr->BGR tables (jdcolor.c).  Anything else (progressive, lossless,
    arithmetic coding, 12-bit, four components, RGB or Adobe-transformed
    colour) raises `JpegError` naming the file; there is no other decoder
    to fall back to.
  * `encode_jpeg` / `write_jpeg`: a baseline 4:2:0 encoder, vectorised in
    numpy down to the bit packing and the 0xFF00 stuffing, with the Annex K
    quantisation tables scaled by quality as libjpeg's jcparam.c scales
    them and the standard Huffman tables.  It writes the fake H36M trees of
    chip_smoke.py; its bytes are not cv2's, but cv2 and `read_jpeg` read
    them alike.

tests/test_torch_jpeg.py holds both to cv2.
"""

from __future__ import annotations

import array
import functools
import os
import re
import struct
from typing import Dict, List, Tuple, Union

import numpy as np

__all__ = ["JpegError", "encode_jpeg", "read_jpeg", "write_jpeg"]


class JpegError(ValueError):
    """A file `read_jpeg` does not decode, or a corrupt one."""


# zigzag position k -> natural (row-major 8x8) index (ITU T.81 figure A.6)
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

_SOF_KIND = {0xC1: "extended sequential", 0xC2: "progressive", 0xC3: "lossless",
             0xC5: "differential sequential", 0xC6: "differential progressive",
             0xC7: "differential lossless", 0xC9: "arithmetic-coded sequential",
             0xCA: "arithmetic-coded progressive", 0xCB: "arithmetic-coded lossless",
             0xCD: "arithmetic-coded differential sequential",
             0xCE: "arithmetic-coded differential progressive",
             0xCF: "arithmetic-coded differential lossless"}
# the end of an entropy-coded segment: a marker other than RSTn (stuffed
# zeros and fill bytes are not markers)
_SCAN_END = re.compile(rb"\xff[^\x00\xd0-\xd7\xff]")
_RESTART = re.compile(rb"\xff+[\xd0-\xd7]")


# -------------------------------------------------------------- Huffman
@functools.lru_cache(maxsize=64)
def _lookup(spec: bytes, ac: bool) -> list:
    """A Huffman table (its 16 counts and symbols as a DHT segment holds
    them) as a list over every 16-bit peek of the bit stream:
    (bits consumed, run, size, value), where the value's extra bits are
    consumed with the code when both fit in the peek, else value is None
    and the caller reads `size` more bits.  None where no code matches."""
    counts = np.frombuffer(spec[:16], np.uint8).astype(np.int64)
    symbols = np.frombuffer(spec[16:], np.uint8).astype(np.int64)
    lengths = np.repeat(np.arange(1, 17), counts)
    codes, code, k = np.empty(len(symbols), np.int64), 0, 0
    for n in counts:
        codes[k:k + n] = code + np.arange(n)
        code = (code + n) << 1
        k += n
    if (codes >= (1 << lengths)).any():
        raise JpegError("bad Huffman table")
    span = 1 << (16 - lengths)
    which = np.repeat(np.arange(len(symbols)), span)
    peek = np.repeat(codes << (16 - lengths), span) + (
        np.arange(len(which)) - np.repeat(np.cumsum(span) - span, span))
    length, sym = lengths[which], symbols[which]
    run, size = (sym >> 4, sym & 15) if ac else (np.zeros_like(sym), sym)
    fits = (length + size <= 16) & (size > 0)
    bits = (peek >> np.maximum(16 - length - size, 0)) & ((1 << size) - 1)
    value = np.where(bits >= (1 << np.maximum(size - 1, 0)), bits, bits - (1 << size) + 1)
    table: list = [None] * 65536
    for p, n, r, s, f, v in zip(peek.tolist(), (length + size * fits).tolist(), run.tolist(),
                                size.tolist(), fits.tolist(), value.tolist()):
        table[p] = (n, r, s, v if f else (0 if s == 0 else None))
    return table


def _windows(seg: bytes) -> list:
    """The bytes of an entropy-coded segment, unstuffed, as 32-bit
    big-endian windows at every byte offset (zeros past the end, as libjpeg
    reads them)."""
    b = np.frombuffer(seg.replace(b"\xff\x00", b"\xff") + bytes(8), np.uint8).astype(np.uint32)
    return ((b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8) | b[3:]).tolist()


_NATURAL = ZIGZAG.tolist()


def _decode_segment(seg: bytes, bases: List[int], comps: List[int], dc_tabs: list,
                    ac_tabs: list, ncomp: int, out: array.array, name: str) -> None:
    """Huffman-decode one restart interval: the blocks at flat coefficient
    offsets `bases` of scan components `comps`, each coefficient stored at
    out[base + its natural (row-major) position]."""
    W = _windows(seg)
    pos = 0
    pred = [0] * ncomp
    zz = _NATURAL
    try:
        for base, c in zip(bases, comps):
            n, _, s, v = dc_tabs[c][(W[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
            pos += n
            if v is None:
                bits = (W[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                pos += s
                v = bits if bits >> (s - 1) else bits - (1 << s) + 1
            pred[c] += v
            out[base] = pred[c]
            ac = ac_tabs[c]
            k = 1
            while k < 64:
                n, r, s, v = ac[(W[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                pos += n
                if s == 0:
                    if r != 15:
                        break  # EOB
                    k += 16  # ZRL
                    continue
                if v is None:
                    bits = (W[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                    pos += s
                    v = bits if bits >> (s - 1) else bits - (1 << s) + 1
                k += r
                out[base + zz[k]] = v
                k += 1
    except TypeError:  # a None entry: no Huffman code matches the bits
        raise JpegError(f"{name}: corrupt JPEG data (bad Huffman code)") from None
    except IndexError:  # a run past the block's 63rd coefficient
        raise JpegError(f"{name}: corrupt JPEG data (coefficient run past 63)") from None


# -------------------------------------------------------------- IDCT
CONST_BITS, PASS1_BITS = 13, 2
FIX_0_298631336, FIX_0_390180644, FIX_0_541196100 = 2446, 3196, 4433
FIX_0_765366865, FIX_0_899976223, FIX_1_175875602 = 6270, 7373, 9633
FIX_1_501321110, FIX_1_847759065, FIX_1_961570560 = 12299, 15137, 16069
FIX_2_053119869, FIX_2_562915447, FIX_3_072711026 = 16819, 20995, 25172


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _idct_pass(d, shift: int):
    """One pass of jidctint.c's jpeg_idct_islow over 8 int64 arrays (the 8
    inputs of each column in pass 1, of each row in pass 2), descaled by
    `shift`."""
    z2, z3 = d[2], d[6]
    z1 = (z2 + z3) * FIX_0_541196100
    tmp2 = z1 - z3 * FIX_1_847759065
    tmp3 = z1 + z2 * FIX_0_765366865
    tmp0 = (d[0] + d[4]) << CONST_BITS
    tmp1 = (d[0] - d[4]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = d[7], d[5], d[3], d[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * FIX_1_175875602
    t0 = t0 * FIX_0_298631336
    t1 = t1 * FIX_2_053119869
    t2 = t2 * FIX_3_072711026
    t3 = t3 * FIX_1_501321110
    z1 = z1 * -FIX_0_899976223
    z2 = z2 * -FIX_2_562915447
    z3 = z3 * -FIX_1_961570560 + z5
    z4 = z4 * -FIX_0_390180644 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    return [_descale(x, shift) for x in (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                                         tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def _range_limit() -> np.ndarray:
    """jdmaster.c's post-IDCT range-limit table, indexed by (x & 1023):
    x + 128 clamped to 0..255 for |x| < 512, wrapping beyond as there."""
    x = np.arange(1024)
    return np.where(x < 128, x + 128, np.where(x < 512, 255, np.where(x < 896, 0, x - 896))
                    ).astype(np.uint8)


_RANGE_LIMIT = _range_limit()


def idct_islow(coef: np.ndarray) -> np.ndarray:
    """(N, 64) dequantised coefficients in natural order -> (N, 8, 8) uint8
    samples, as libjpeg-turbo's jpeg_idct_islow computes them.  A block
    whose AC coefficients are all 0 takes the shortcut libjpeg takes, which
    gives the same samples: 8 x 8 of range_limit[((dc << 2) + 16) >> 5]."""
    coef = np.asarray(coef, np.int64)
    out = np.empty((len(coef), 8, 8), np.uint8)
    ac = coef[:, 1:].any(axis=1)
    flat = ~ac
    out[flat] = _RANGE_LIMIT[(((coef[flat, 0] << PASS1_BITS) + 16) >> 5) & 1023][:, None, None]
    c = coef[ac].reshape(-1, 8, 8)
    ws = np.stack(_idct_pass([c[:, k, :] for k in range(8)], CONST_BITS - PASS1_BITS),
                  axis=1)  # columns: ws[:, row, col]
    rows = np.stack(_idct_pass([ws[:, :, k] for k in range(8)], CONST_BITS + PASS1_BITS + 3),
                    axis=2)
    out[ac] = _RANGE_LIMIT[rows & 1023]
    return out


# -------------------------------------------------------------- upsampling
def _edge(a: np.ndarray, axis: int, before: bool) -> np.ndarray:
    """`a` shifted by one along `axis` with its edge replicated: the
    neighbour before (or after) each sample."""
    n = a.shape[axis]
    idx = np.clip(np.arange(n) + (-1 if before else 1), 0, n - 1)
    return np.take(a, idx, axis=axis)


def upsample(plane: np.ndarray, h_ratio: int, v_ratio: int, fancy_width_ok: bool) -> np.ndarray:
    """A downsampled component plane (its real samples only) to full size
    as libjpeg-turbo's jdsample.c does with fancy upsampling on: the
    triangle filters for 2x1, 1x2 and 2x2 (box replication for 2x1 and 2x2
    where the component is at most 2 samples wide), box replication for
    the other integer ratios."""
    p = plane.astype(np.int32)
    if h_ratio == 1 and v_ratio == 1:
        return plane
    if h_ratio == 2 and v_ratio == 1 and fancy_width_ok:  # h2v1_fancy_upsample
        out = np.empty((p.shape[0], 2 * p.shape[1]), np.int32)
        out[:, 0::2] = (3 * p + _edge(p, 1, True) + 1) >> 2
        out[:, 1::2] = (3 * p + _edge(p, 1, False) + 2) >> 2
        return out.astype(np.uint8)
    if h_ratio == 1 and v_ratio == 2:  # h1v2_fancy_upsample
        out = np.empty((2 * p.shape[0], p.shape[1]), np.int32)
        out[0::2] = (3 * p + _edge(p, 0, True) + 1) >> 2
        out[1::2] = (3 * p + _edge(p, 0, False) + 2) >> 2
        return out.astype(np.uint8)
    if h_ratio == 2 and v_ratio == 2 and fancy_width_ok:  # h2v2_fancy_upsample
        out = np.empty((2 * p.shape[0], 2 * p.shape[1]), np.int32)
        for rows, far in ((slice(0, None, 2), _edge(p, 0, True)),
                          (slice(1, None, 2), _edge(p, 0, False))):
            s = 3 * p + far  # column sums: 3 x nearer row + further row
            out[rows, 0::2] = (3 * s + _edge(s, 1, True) + 8) >> 4
            out[rows, 1::2] = (3 * s + _edge(s, 1, False) + 7) >> 4
        return out.astype(np.uint8)
    return np.repeat(np.repeat(plane, v_ratio, axis=0), h_ratio, axis=1)


# -------------------------------------------------------------- colour
def _ycc_tables():
    """jdcolor.c's build_ycc_rgb_table (SCALEBITS 16, ONE_HALF rounding):
    the Cr->R and Cb->B offsets, and the Cb,Cr->G offset of every (Cb, Cr)
    pair (index cb * 256 + cr), as int16."""
    x = np.arange(256, dtype=np.int64) - 128

    def fix(v):
        return int(v * (1 << 16) + 0.5)

    cr_r = (fix(1.40200) * x + (1 << 15)) >> 16
    cb_b = (fix(1.77200) * x + (1 << 15)) >> 16
    cb_g = -fix(0.34414) * x + (1 << 15)
    cr_g = -fix(0.71414) * x
    g = (cb_g[:, None] + cr_g[None, :]) >> 16
    return cr_r.astype(np.int16), cb_b.astype(np.int16), g.reshape(-1).astype(np.int16)


_CR_R, _CB_B, _CBCR_G = _ycc_tables()
# the sample range limit: x -> x clamped to 0..255, at index x + 512
_CLAMP = np.clip(np.arange(-512, 768), 0, 255).astype(np.uint8)


def ycc_to_bgr(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """uint8 Y, Cb, Cr planes -> (H, W, 3) uint8 BGR (jdcolor.c
    ycc_rgb_convert, its outputs clamped to 0..255)."""
    y = y.astype(np.int16) + 512
    out = np.empty(y.shape + (3,), np.uint8)
    out[..., 0] = _CLAMP[y + _CB_B[cb]]
    out[..., 1] = _CLAMP[y + _CBCR_G[(cb.astype(np.int32) << 8) | cr]]
    out[..., 2] = _CLAMP[y + _CR_R[cr]]
    return out


# -------------------------------------------------------------- decoder
def read_jpeg(src: Union[str, os.PathLike, bytes, bytearray, memoryview, np.ndarray],
              name: str = None) -> np.ndarray:
    """A baseline JPEG (a path, or its bytes) as (H, W, 3) uint8 BGR, as
    cv2.imread(path, IMREAD_COLOR | IMREAD_IGNORE_ORIENTATION) and
    cv2.imdecode give it.  `name` names bytes in error messages.  Raises
    JpegError on anything else."""
    if isinstance(src, (bytes, bytearray, memoryview, np.ndarray)):
        data = bytes(memoryview(src).cast("B")) if not isinstance(src, bytes) else src
        name = name or "<JPEG bytes>"
    else:
        name = name or os.fspath(src)
        with open(src, "rb") as f:
            data = f.read()
    return _decode(data, name)


def _decode(data: bytes, name: str) -> np.ndarray:
    if data[:2] != b"\xff\xd8":
        raise JpegError(f"{name}: not a JPEG file (no SOI marker)")
    qt: Dict[int, np.ndarray] = {}
    huff: Dict[Tuple[int, int], list] = {}
    frame = None
    restart = 0
    saw_jfif = False
    adobe = None
    coef = array.array("i")  # every component's blocks' coefficients, flat
    pos = 2
    while True:
        if pos + 2 > len(data) or data[pos] != 0xFF:
            raise JpegError(f"{name}: corrupt JPEG data (no marker at byte {pos})")
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            raise JpegError(f"{name}: truncated JPEG (no EOI marker)")
        marker = data[pos]
        pos += 1
        if marker == 0xD9:  # EOI
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        if pos + 2 > len(data):
            raise JpegError(f"{name}: truncated JPEG")
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        body = data[pos + 2:pos + length]
        pos += length
        if len(body) != length - 2:
            raise JpegError(f"{name}: truncated JPEG")
        if marker == 0xDB:  # DQT
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                n = 128 if pq else 64
                table = np.frombuffer(body[i + 1:i + 1 + n], ">u2" if pq else np.uint8)
                nat = np.empty(64, np.int64)
                nat[ZIGZAG] = table
                qt[tq] = nat
                i += 1 + n
        elif marker == 0xC4:  # DHT
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                n = sum(body[i + 1:i + 17])
                huff[(tc, th)] = _lookup(bytes(body[i + 1:i + 17 + n]), tc == 1)
                i += 17 + n
        elif marker == 0xDD:  # DRI
            (restart,) = struct.unpack(">H", body[:2])
        elif marker == 0xE0 and body[:5] == b"JFIF\x00":
            saw_jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe":
            adobe = body[11] if len(body) > 11 else None
        elif marker == 0xC0:  # SOF0, baseline
            precision, height, width, ncomp = struct.unpack(">BHHB", body[:6])
            if precision != 8:
                raise JpegError(f"{name}: {precision}-bit samples; read_jpeg takes 8-bit "
                                "baseline JPEGs")
            if ncomp not in (1, 3):
                raise JpegError(f"{name}: {ncomp} components (CMYK/YCCK?); read_jpeg takes "
                                "grey or YCbCr JPEGs")
            if height == 0 or width == 0:
                raise JpegError(f"{name}: image of {width}x{height} (DNL is not supported)")
            comps = [dict(id=body[6 + 3 * c], h=body[7 + 3 * c] >> 4, v=body[7 + 3 * c] & 15,
                          tq=body[8 + 3 * c]) for c in range(ncomp)]
            frame = _frame(width, height, comps, name)
            coef = array.array("i", bytes(4 * frame["comps"][-1]["end"]))
        elif marker in _SOF_KIND or marker == 0xCC:
            kind = _SOF_KIND.get(marker, "arithmetic-coded")
            raise JpegError(f"{name}: {kind} JPEG (SOF{marker - 0xC0}); read_jpeg takes "
                            "baseline (SOF0) JPEGs only")
        elif marker == 0xDC:
            raise JpegError(f"{name}: DNL marker is not supported")
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise JpegError(f"{name}: scan before the frame header")
            m = _SCAN_END.search(data, pos)
            end = m.start() if m else len(data)
            _scan(data[pos:end], body, frame, qt, huff, restart, coef, name)
            pos = end
    if frame is None:
        raise JpegError(f"{name}: no frame header")
    comps = frame["comps"]
    if len(comps) == 3:
        ids = tuple(c["id"] for c in comps)
        if adobe is not None and adobe != 1:
            raise JpegError(f"{name}: Adobe colour transform {adobe} (RGB or YCCK); read_jpeg "
                            "takes YCbCr JPEGs")
        if not saw_jfif and adobe is None and ids == (82, 71, 66):
            raise JpegError(f"{name}: RGB JPEG (component ids 'R', 'G', 'B'); read_jpeg takes "
                            "YCbCr JPEGs")
    planes = []
    for f in comps:
        if f["tq"] not in qt:
            raise JpegError(f"{name}: component {f['id']} uses a missing quantisation table")
        blocks = idct_islow(np.frombuffer(coef, np.int32)[f["start"]:f["end"]].reshape(-1, 64)
                            * qt[f["tq"]])
        plane = blocks.reshape(f["rows"], f["cols"], 8, 8).transpose(0, 2, 1, 3).reshape(
            f["rows"] * 8, f["cols"] * 8)[:f["dh"], :f["dw"]]
        plane = upsample(plane, frame["hmax"] // f["h"], frame["vmax"] // f["v"],
                         f["dw"] > 2)
        planes.append(plane[:frame["height"], :frame["width"]])
    if len(planes) == 1:
        return np.repeat(planes[0][..., None], 3, axis=2)
    return ycc_to_bgr(*planes)


def _frame(width: int, height: int, comps: List[dict], name: str) -> dict:
    """The frame's geometry: MCUs, and per component its real sample width
    and height, its block grid (padded to whole MCUs) and its offsets in
    the flat coefficient array."""
    if any(not (1 <= c["h"] <= 4 and 1 <= c["v"] <= 4) for c in comps):
        raise JpegError(f"{name}: bad sampling factors")
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    end = 0
    for c in comps:
        if hmax % c["h"] or vmax % c["v"]:
            raise JpegError(f"{name}: fractional sampling {c['h']}x{c['v']} of {hmax}x{vmax}")
        c["dw"] = -(-width * c["h"] // hmax)
        c["dh"] = -(-height * c["v"] // vmax)
        c["rows"], c["cols"] = mcuy * c["v"], mcux * c["h"]
        c["start"], end = end, end + c["rows"] * c["cols"] * 64
        c["end"] = end
    return dict(width=width, height=height, hmax=hmax, vmax=vmax, mcux=mcux, mcuy=mcuy,
                comps=comps)


def _scan(seg: bytes, header: bytes, frame: dict, qt: dict, huff: dict, restart: int,
          coef: array.array, name: str) -> None:
    """Decode one baseline scan into the frame's flat coefficient list."""
    ns = header[0]
    by_id = {c["id"]: i for i, c in enumerate(frame["comps"])}
    members, dc_tabs, ac_tabs = [], [], []
    for j in range(ns):
        cid, tabs = header[1 + 2 * j], header[2 + 2 * j]
        if cid not in by_id:
            raise JpegError(f"{name}: scan names unknown component {cid}")
        members.append(by_id[cid])
        try:
            dc_tabs.append(huff[(0, tabs >> 4)])
            ac_tabs.append(huff[(1, tabs & 15)])
        except KeyError:
            raise JpegError(f"{name}: scan uses a missing Huffman table") from None
    ss, se, ahal = header[1 + 2 * ns:4 + 2 * ns]
    if (ss, se, ahal) != (0, 63, 0):
        raise JpegError(f"{name}: scan of spectral selection {ss}..{se}, approximation {ahal}; "
                        "read_jpeg takes baseline scans")
    comps = frame["comps"]
    # the flat offset of every block in decode order, an MCU at a time; in
    # a one-component scan an MCU is one block, over the blocks that hold the
    # component's samples (not the interleaved MCU grid)
    if ns == 1:
        c = comps[members[0]]
        rows, cols = -(-c["dh"] // 8), -(-c["dw"] // 8)
        r, q = np.divmod(np.arange(rows * cols), cols)
        bases = c["start"] + (r * c["cols"] + q) * 64
        which = np.zeros(rows * cols, np.int64)
        per_mcu = 1
    else:
        my, mx = np.divmod(np.arange(frame["mcuy"] * frame["mcux"]), frame["mcux"])
        parts, owner = [], []
        for j, ci in enumerate(members):
            c = comps[ci]
            for v in range(c["v"]):
                for h in range(c["h"]):
                    parts.append(c["start"] + ((my * c["v"] + v) * c["cols"] + mx * c["h"] + h) * 64)
                    owner.append(j)
        per_mcu = len(parts)
        bases = np.stack(parts, axis=1).reshape(-1)
        which = np.tile(owner, len(my))
    bases, which = bases.tolist(), which.tolist()
    step = (restart * per_mcu) if restart else len(bases)
    n_intervals = -(-len(bases) // step)
    pieces = _RESTART.split(seg) if restart else [seg]
    if len(pieces) < n_intervals:
        raise JpegError(f"{name}: corrupt JPEG data ({len(pieces)} restart intervals, "
                        f"{n_intervals} expected)")
    for i in range(n_intervals):
        _decode_segment(pieces[i], bases[i * step:(i + 1) * step],
                        which[i * step:(i + 1) * step], dc_tabs, ac_tabs, ns, coef, name)


# -------------------------------------------------------------- encoder
# ITU T.81 Annex K.1, natural order
_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_CHROMA_Q = np.full(64, 99)
_CHROMA_Q.reshape(8, 8)[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66], [24, 26, 56, 99],
                                   [47, 66, 99, 99]]
# Annex K.3: (counts of codes of length 1..16, symbols)
_DC_LUMA = (bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]), bytes(range(12)))
_DC_CHROMA = (bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]), bytes(range(12)))
_AC_LUMA = (bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]), bytes.fromhex(
    "01 02 03 00 04 11 05 12 21 31 41 06 13 51 61 07 22 71 14 32 81 91 a1 08"
    " 23 42 b1 c1 15 52 d1 f0 24 33 62 72 82 09 0a 16 17 18 19 1a 25 26 27 28"
    " 29 2a 34 35 36 37 38 39 3a 43 44 45 46 47 48 49 4a 53 54 55 56 57 58 59"
    " 5a 63 64 65 66 67 68 69 6a 73 74 75 76 77 78 79 7a 83 84 85 86 87 88 89"
    " 8a 92 93 94 95 96 97 98 99 9a a2 a3 a4 a5 a6 a7 a8 a9 aa b2 b3 b4 b5 b6"
    " b7 b8 b9 ba c2 c3 c4 c5 c6 c7 c8 c9 ca d2 d3 d4 d5 d6 d7 d8 d9 da e1 e2"
    " e3 e4 e5 e6 e7 e8 e9 ea f1 f2 f3 f4 f5 f6 f7 f8 f9 fa"))
_AC_CHROMA = (bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]), bytes.fromhex(
    "00 01 02 03 11 04 05 21 31 06 12 41 51 07 61 71 13 22 32 81 08 14 42 91"
    " a1 b1 c1 09 23 33 52 f0 15 62 72 d1 0a 16 24 34 e1 25 f1 17 18 19 1a 26"
    " 27 28 29 2a 35 36 37 38 39 3a 43 44 45 46 47 48 49 4a 53 54 55 56 57 58"
    " 59 5a 63 64 65 66 67 68 69 6a 73 74 75 76 77 78 79 7a 82 83 84 85 86 87"
    " 88 89 8a 92 93 94 95 96 97 98 99 9a a2 a3 a4 a5 a6 a7 a8 a9 aa b2 b3 b4"
    " b5 b6 b7 b8 b9 ba c2 c3 c4 c5 c6 c7 c8 c9 ca d2 d3 d4 d5 d6 d7 d8 d9 da"
    " e2 e3 e4 e5 e6 e7 e8 e9 ea f2 f3 f4 f5 f6 f7 f8 f9 fa"))


def quality_tables(quality: int) -> Tuple[np.ndarray, np.ndarray]:
    """The Annex K luminance and chrominance tables scaled to `quality` as
    jcparam.c's jpeg_quality_scaling and jpeg_add_quant_table (baseline)
    scale them; natural order."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return tuple(np.clip((t * scale + 50) // 100, 1, 255) for t in (_LUMA_Q, _CHROMA_Q))


def _codes(spec) -> Tuple[np.ndarray, np.ndarray]:
    """(code, length) of every symbol 0..255 of a Huffman table spec."""
    counts, symbols = spec
    code_of, len_of = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, k = 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            code_of[symbols[k]], len_of[symbols[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


def _dct_matrix() -> np.ndarray:
    k = np.arange(8)
    m = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) * 0.5
    m[0] /= np.sqrt(2.0)
    return m


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(H, W) with H, W multiples of 8 -> (H/8, W/8, 8, 8)."""
    H, W = plane.shape
    return plane.reshape(H // 8, 8, W // 8, 8).transpose(0, 2, 1, 3)


def encode_jpeg(bgr: np.ndarray, quality: int = 92) -> bytes:
    """A (H, W, 3) uint8 BGR image as a baseline 4:2:0 JFIF JPEG."""
    img = np.asarray(bgr, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_jpeg takes (H, W, 3) BGR images, not {img.shape}")
    H, W = img.shape[:2]
    pad = np.pad(img.astype(np.float64), ((0, -H % 16), (0, -W % 16), (0, 0)), mode="edge")
    b, g, r = pad[..., 0], pad[..., 1], pad[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    Hp, Wp = y.shape
    cb, cr = (c.reshape(Hp // 2, 2, Wp // 2, 2).mean(axis=(1, 3)) for c in (cb, cr))
    qy, qc = quality_tables(quality)
    D = _dct_matrix()
    mcuy, mcux = Hp // 16, Wp // 16

    def quantised(plane, q):
        blk = _blocks(np.round(plane) - 128.0)
        f = D @ blk @ D.T
        return np.round(f.reshape(*blk.shape[:2], 64) / q).astype(np.int64)

    yq = quantised(y, qy).reshape(mcuy, 2, mcux, 2, 64).transpose(0, 2, 1, 3, 4)
    cbq, crq = quantised(cb, qc), quantised(cr, qc)
    # blocks in decode order: per MCU, Y00 Y01 Y10 Y11 Cb Cr
    order = np.concatenate([yq.reshape(mcuy, mcux, 4, 64), cbq[:, :, None], crq[:, :, None]],
                           axis=2).reshape(-1, 64)[:, ZIGZAG]
    comp = np.tile([0, 0, 0, 0, 1, 2], mcuy * mcux)
    return _headers(W, H, qy, qc) + _entropy(order, comp) + b"\xff\xd9"


def _headers(W: int, H: int, qy: np.ndarray, qc: np.ndarray) -> bytes:
    def seg(marker: int, body: bytes) -> bytes:
        return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body

    out = b"\xff\xd8" + seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    out += seg(0xDB, bytes([0]) + qy[ZIGZAG].astype(np.uint8).tobytes()
               + bytes([1]) + qc[ZIGZAG].astype(np.uint8).tobytes())
    out += seg(0xC0, struct.pack(">BHHB", 8, H, W, 3)
               + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1]))
    out += seg(0xC4, b"".join(bytes([cls]) + counts + symbols for cls, (counts, symbols) in (
        (0x00, _DC_LUMA), (0x10, _AC_LUMA), (0x01, _DC_CHROMA), (0x11, _AC_CHROMA))))
    return out + seg(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))


def _size(v: np.ndarray) -> np.ndarray:
    """The JPEG magnitude category of each value: bits of |v|."""
    a = np.abs(v)
    s = np.zeros(a.shape, np.int64)
    nz = a > 0
    s[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    return s


def _entropy(blocks: np.ndarray, comp: np.ndarray) -> bytes:
    """Huffman-code (N, 64) zigzag-ordered blocks of components `comp`
    (0 luma, 1 and 2 chroma), pack the bits and stuff the 0xFF bytes."""
    n = len(blocks)
    chroma = comp > 0
    dc_code = [_codes(_DC_LUMA), _codes(_DC_CHROMA)]
    ac_code = [_codes(_AC_LUMA), _codes(_AC_CHROMA)]
    # DC differences within each component
    dc = blocks[:, 0].copy()
    diff = np.empty(n, np.int64)
    for c in range(3):
        sel = np.flatnonzero(comp == c)
        diff[sel] = np.diff(dc[sel], prepend=0)
    keys, codes, lengths = [], [], []

    def emit(key, table_sel, symbol, value, size, tables):
        (lc, ll), (cc, cl) = tables
        code = np.where(table_sel, cc[symbol], lc[symbol])
        length = np.where(table_sel, cl[symbol], ll[symbol])
        extra = np.where(value < 0, value + (1 << size) - 1, value) & ((1 << size) - 1)
        keys.append(key)
        codes.append((code << size) | extra)
        lengths.append(length + size)

    ds = _size(diff)
    emit(np.arange(n) * 1024, chroma, ds, diff, ds, dc_code)
    blk, k = np.nonzero(blocks[:, 1:])
    k = k + 1
    prev = np.concatenate([[0], k[:-1]])
    prev[np.concatenate([[True], blk[1:] != blk[:-1]])] = 0
    run = k - prev - 1
    v = blocks[blk, k]
    s = _size(v)
    emit(blk * 1024 + k * 4 + 3, chroma[blk], (run % 16) * 16 + s, v, s, ac_code)
    for z in range(3):  # ZRL symbols for runs of 16 zeros
        sel = run // 16 > z
        zeros = np.zeros(sel.sum(), np.int64)
        emit(blk[sel] * 1024 + k[sel] * 4 + z, chroma[blk[sel]], zeros + 0xF0, zeros, zeros,
             ac_code)
    last = np.zeros(n, np.int64)
    last[blk] = k  # the last nonzero AC position of each block (k ascends)
    eob = np.flatnonzero(last < 63)
    zeros = np.zeros(len(eob), np.int64)
    emit(eob * 1024 + 256, chroma[eob], zeros, zeros, zeros, ac_code)
    order = np.argsort(np.concatenate(keys), kind="stable")
    code = np.concatenate(codes)[order]
    length = np.concatenate(lengths)[order]
    total = int(length.sum())
    sym = np.repeat(np.arange(len(length)), length)
    within = np.arange(total) - np.repeat(np.cumsum(length) - length, length)
    bits = ((code[sym] >> (length[sym] - 1 - within)) & 1).astype(np.uint8)
    bits = np.concatenate([bits, np.ones(-total % 8, np.uint8)])  # pad with 1-bits
    out = np.packbits(bits)
    ff = np.flatnonzero(out == 0xFF)
    return np.insert(out, ff + 1, 0).tobytes()


def write_jpeg(path: Union[str, os.PathLike], bgr: np.ndarray, quality: int = 92) -> None:
    """Write a (H, W, 3) uint8 BGR image as a baseline 4:2:0 JPEG."""
    with open(path, "wb") as f:
        f.write(encode_jpeg(bgr, quality))
