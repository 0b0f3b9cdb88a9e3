"""The JAX package's checkpoint format (flax msgpack `.ckpt`), read and
written without msgpack, flax or JAX.

The JAX `Checkpointer.save` writes `flax.serialization.msgpack_serialize`
of {"state": <TrainState as a state dict>, "extra": {...}}.  That is plain
msgpack (maps, arrays, strings, numbers) with flax's ext types:

  * code 1, an array: the msgpack array (shape, dtype name, C-order bytes),
    packed with `use_bin_type`; the dtype name `bfloat16`, which numpy
    lacks, comes back as a `torch.bfloat16` tensor through a uint16 view;
  * code 3, a numpy scalar: the same encoding of a 0-d array.

Any other ext type (flax's code 2 is a Python complex, which no checkpoint
of these models holds) raises MsgpackError.

Arrays over `MAX_CHUNK_SIZE` bytes are written as
{"__msgpack_chunked_array__": True, "shape": {"0": .., ...}, "chunks":
{"0": flat piece, ...}}, which `restore` joins again.

`restore` decodes such bytes; `serialize` writes the bytes that flax's
`msgpack_serialize` writes for the same tree (numpy arrays and scalars,
and torch tensors, which go out as numpy arrays or as `bfloat16`).
`read_checkpoint` reads a file's `state.params` and `state.batch_stats`
as JAX `utils/pretrained.py:_native_checkpoint_params` does, with its
`extra`; `write_checkpoint` packs a port model's weights into that layout
(tests and chip_smoke.py write files with it; no engine path does).
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Tuple

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30  # flax.serialization's, in bytes
CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_NPSCALAR = 1, 3


class MsgpackError(ValueError):
    pass


# ------------------------------------------------------------------ decode

class _Reader:
    def __init__(self, data, raw: bool):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise MsgpackError("msgpack: data ends inside an object")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.text(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in sized:
            return bytes(self.take(self.unpack(sized[b])))
        ext = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in ext:
            n = self.unpack(ext[b])
            return self.ext(n)
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        texts = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in texts:
            return self.text(self.unpack(texts[b]))
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise MsgpackError(f"msgpack: unknown type byte 0x{b:02x}")

    def text(self, n: int):
        data = bytes(self.take(n))
        return data if self.raw else data.decode("utf-8")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext(self, n: int):
        code = struct.unpack("b", self.take(1))[0]
        data = self.take(n)
        if code == EXT_NDARRAY:
            return _array_from_bytes(data)
        if code == EXT_NPSCALAR:
            arr = _array_from_bytes(data)
            return arr[()] if isinstance(arr, np.ndarray) else arr.reshape(())
        raise MsgpackError(f"msgpack: unknown ext type {code}")


def _array_from_bytes(data):
    """flax `_ndarray_from_bytes`: (shape, dtype name, bytes) -> an array."""
    shape, name, buf = _Reader(data, raw=True).obj()
    name = name.decode()
    if name == "bfloat16":
        flat = np.frombuffer(buf, np.uint16).copy()
        return torch.from_numpy(flat).view(torch.bfloat16).reshape(tuple(shape))
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)


def _unchunk(tree):
    if isinstance(tree, dict):
        if CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            if isinstance(chunks[0], torch.Tensor):
                return torch.cat(chunks).reshape(shape)
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def restore(data) -> Any:
    """flax `msgpack_restore`: bytes -> a tree of dicts, lists, scalars and
    arrays (numpy; torch.bfloat16 tensors for bfloat16), chunks joined."""
    reader = _Reader(data, raw=False)
    tree = reader.obj()
    if reader.pos != len(reader.data):
        raise MsgpackError(f"msgpack: {len(reader.data) - reader.pos} bytes after the object")
    return _unchunk(tree)


# ------------------------------------------------------------------ encode

def _header(out: bytearray, n: int, fix: int, fix_max: int, codes) -> None:
    """A length header: the fix form below fix_max, else the first of the
    (limit, code, struct format) forms that holds n."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
        return
    for limit, code, fmt in codes:
        if n <= limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise MsgpackError(f"msgpack: length {n} too large")


_BIN = ((0xFF, 0xC4, ">B"), (0xFFFF, 0xC5, ">H"), (0xFFFFFFFF, 0xC6, ">I"))
_STR = ((0xFF, 0xD9, ">B"), (0xFFFF, 0xDA, ">H"), (0xFFFFFFFF, 0xDB, ">I"))
_ARRAY = ((0xFFFF, 0xDC, ">H"), (0xFFFFFFFF, 0xDD, ">I"))
_MAP = ((0xFFFF, 0xDE, ">H"), (0xFFFFFFFF, 0xDF, ">I"))


def _int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80 or -0x20 <= v < 0:
        out += struct.pack("b" if v < 0 else "B", v)
        return
    for lo, hi, code, fmt in ((0x80, 0xFF, 0xCC, ">B"), (-0x80, -1, 0xD0, ">b"),
                              (0x100, 0xFFFF, 0xCD, ">H"), (-0x8000, -0x81, 0xD1, ">h"),
                              (0x10000, 0xFFFFFFFF, 0xCE, ">I"),
                              (-0x80000000, -0x8001, 0xD2, ">i"),
                              (0x100000000, 0xFFFFFFFFFFFFFFFF, 0xCF, ">Q"),
                              (-0x8000000000000000, -0x80000001, 0xD3, ">q")):
        if lo <= v <= hi:
            out.append(code)
            out += struct.pack(fmt, v)
            return
    raise MsgpackError(f"msgpack: integer {v} out of range")


def _pack_plain(out: bytearray, obj) -> None:
    """msgpack.packb(use_bin_type=True) of flax's array header: the
    (shape, dtype name, bytes) tuple, tuples as arrays."""
    if isinstance(obj, tuple):
        _header(out, len(obj), 0x90, 0x0F, _ARRAY)
        for v in obj:
            _pack_plain(out, v)
    elif isinstance(obj, int):
        _int(out, int(obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _header(out, len(data), 0xA0, 0x1F, _STR)
        out += data
    else:
        _header(out, len(obj), None, -1, _BIN)
        out += obj


def _array_bytes(arr) -> bytes:
    """flax `_ndarray_to_bytes`."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            shape, name, buf = tuple(t.shape), "bfloat16", t.view(torch.int16).numpy().tobytes()
        else:
            a = t.numpy()
            shape, name, buf = a.shape, a.dtype.name, a.tobytes("C")
    else:
        shape, name, buf = arr.shape, arr.dtype.name, arr.tobytes("C")
    out = bytearray()
    _pack_plain(out, (tuple(shape), name, buf))
    return bytes(out)


def _ext(out: bytearray, code: int, data: bytes) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    else:
        _header(out, n, None, -1, ((0xFF, 0xC7, ">B"), (0xFFFF, 0xC8, ">H"),
                                   (0xFFFFFFFF, 0xC9, ">I")))
    out += struct.pack("b", code)
    out += data


def _nbytes(arr) -> int:
    return arr.numel() * arr.element_size() if isinstance(arr, torch.Tensor) else arr.nbytes


def _chunk(arr, max_chunk: int) -> dict:
    """flax `_chunk`: an oversized array as its canonical chunk dict."""
    itemsize = arr.element_size() if isinstance(arr, torch.Tensor) else arr.dtype.itemsize
    size = max(1, int(max_chunk / itemsize))
    flat = arr.reshape(-1)
    n = flat.shape[0]
    return {CHUNKED: True, "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): flat[s:s + size] for i, s in enumerate(range(0, n, size))}}


def _pack(out: bytearray, obj, max_chunk: int) -> None:
    """msgpack.packb(strict_types=True, default=flax's ext packer) of a
    tree whose oversized arrays flax would chunk."""
    kind = type(obj)
    if obj is None or kind is bool:
        out.append({None: 0xC0, False: 0xC2, True: 0xC3}[obj])
    elif kind is int:
        _int(out, obj)
    elif kind is float:
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif kind in (str, bytes, bytearray):
        _pack_plain(out, obj)
    elif kind is list:
        _header(out, len(obj), 0x90, 0x0F, _ARRAY)
        for v in obj:
            _pack(out, v, max_chunk)
    elif kind is dict:
        _header(out, len(obj), 0x80, 0x0F, _MAP)
        for k, v in obj.items():
            _pack(out, k, max_chunk)
            _pack(out, v, max_chunk)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        if _nbytes(obj) > max_chunk:
            _pack(out, _chunk(obj, max_chunk), max_chunk)
        else:
            _ext(out, EXT_NDARRAY, _array_bytes(obj))
    elif isinstance(obj, np.generic):
        _ext(out, EXT_NPSCALAR, _array_bytes(np.asarray(obj)))
    else:
        raise MsgpackError(f"msgpack: cannot serialize {kind.__name__}")


def _sorted(tree):
    """Dicts with their keys sorted, as flax's `jax.tree_util.tree_map`
    copy of the tree has them."""
    if type(tree) is dict:
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    if type(tree) is list:
        return [_sorted(v) for v in tree]
    return tree


def serialize(tree, max_chunk: int = MAX_CHUNK_SIZE) -> bytes:
    """flax `msgpack_serialize`: the same bytes for the same tree."""
    out = bytearray()
    _pack(out, _sorted(tree), max_chunk)
    return bytes(out)


# ------------------------------------------------------------------ files

def _numpy(value) -> np.ndarray:
    """A leaf as numpy: bfloat16 widens to float32 exactly."""
    if isinstance(value, torch.Tensor):
        return value.float().numpy() if value.dtype == torch.bfloat16 else value.numpy()
    return np.asarray(value)


def _numpy_tree(tree):
    return ({k: _numpy_tree(v) for k, v in tree.items()} if isinstance(tree, dict)
            else _numpy(tree))


def read_checkpoint(path: str) -> Tuple[Dict, Dict, Dict]:
    """A JAX `.ckpt` -> (params, batch_stats, extra): the variables of
    `payload['state']` (or of the payload itself, when it holds no 'state'),
    leaves as numpy arrays, bfloat16 widened to float32."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        payload = restore(data)
    except (MsgpackError, UnicodeDecodeError, struct.error) as e:
        raise MsgpackError(f"{path}: not a flax msgpack checkpoint ({e})") from None
    if not isinstance(payload, dict):
        raise MsgpackError(f"{path}: not a flax msgpack checkpoint (a {type(payload).__name__} "
                           "at the top)")
    state = payload.get("state", payload)
    extra = payload.get("extra") or {}
    return (_numpy_tree(state.get("params", {})), _numpy_tree(state.get("batch_stats") or {}),
            extra)


def write_checkpoint(path: str, model: torch.nn.Module, **extra) -> None:
    """Write `model`'s weights as the JAX Checkpointer lays them out:
    {'state': {'step', 'params', 'batch_stats'}, 'extra': extra}."""
    from .jax_import import flax_variables

    variables = flax_variables(model)
    payload = {"state": {"step": np.asarray(0, np.int32), "params": variables["params"],
                         "batch_stats": variables["batch_stats"]},
               "extra": extra}
    with open(path, "wb") as f:
        f.write(serialize(payload))
