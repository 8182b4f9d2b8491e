"""The flax msgpack format in plain Python (counterpart of
flax.serialization.msgpack_serialize / msgpack_restore, with which the JAX
package writes its checkpoints and its converted-encoder cache), so the
port reads and writes those files without flax, msgpack or jax.

The format is msgpack (maps, strings, bins, ints, floats, bools, nil,
arrays) with two of flax's extension types:
- 1, an array: packb((shape, dtype name, C-order bytes)); "bfloat16" by name;
- 3, a numpy scalar: as an array of shape ().
An array of more than MAX_CHUNK_SIZE bytes reached from the root through
maps only is written as {"__msgpack_chunked_array__": True, "shape":
{"0": ...}, "chunks": {"0": flat piece, ...}}.

`msgpack_serialize` gives flax's bytes for the same tree: map keys in
sorted order (flax's tree_map sorts them; a chunk map keeps its own order)
and msgpack-python's header widths. `to_state_dict` / `relistify` are
flax's list encoding ({"0": ..., "1": ...}) and its inverse, as
wav2vec2forbrain_tpu/models/pretrained.py::_relistify.

Arrays read back as CPU tensors that view the buffer read (no copy per
leaf); torch tensors and numpy arrays are written.
"""

import os
import struct
from typing import Any, Callable

import numpy as np
import torch

MAX_CHUNK_SIZE = 2**30
CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_NPSCALAR = 1, 3
TORCH_DTYPES = {
    name: getattr(torch, name)
    for name in ("float16", "bfloat16", "float32", "float64", "int8", "int16", "int32", "int64", "uint8",
                 "uint16", "uint32", "uint64", "bool")
}


# --- writing ------------------------------------------------------------------


def _int(write: Callable, n: int) -> None:
    """msgpack-python's choice of integer encoding."""
    if 0 <= n < 0x80:
        write(struct.pack("B", n))
    elif -0x20 <= n < 0:
        write(struct.pack("b", n))
    elif 0x80 <= n <= 0xFF:
        write(struct.pack("BB", 0xCC, n))
    elif -0x80 <= n < 0:
        write(struct.pack(">Bb", 0xD0, n))
    elif 0xFF < n <= 0xFFFF:
        write(struct.pack(">BH", 0xCD, n))
    elif -0x8000 <= n < -0x80:
        write(struct.pack(">Bh", 0xD1, n))
    elif 0xFFFF < n <= 0xFFFFFFFF:
        write(struct.pack(">BI", 0xCE, n))
    elif -0x80000000 <= n < -0x8000:
        write(struct.pack(">Bi", 0xD2, n))
    elif 0xFFFFFFFF < n <= 0xFFFFFFFFFFFFFFFF:
        write(struct.pack(">BQ", 0xCF, n))
    elif -0x8000000000000000 <= n < -0x80000000:
        write(struct.pack(">Bq", 0xD3, n))
    else:
        raise OverflowError(f"msgpack: integer {n} out of range")


def _sized(n: int, codes: tuple) -> bytes:
    """A length header in the first of the 8-, 16- and 32-bit forms that
    holds n (a code of None: the type has no such form)."""
    for code, fmt, limit in zip(codes, (">BB", ">BH", ">BI"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            return struct.pack(fmt, code, n)
    raise ValueError(f"msgpack: length {n} too large")


def _str_header(n: int) -> bytes:
    return struct.pack("B", 0xA0 + n) if n <= 31 else _sized(n, (0xD9, 0xDA, 0xDB))


def _bin_header(n: int) -> bytes:
    return _sized(n, (0xC4, 0xC5, 0xC6))


def _array_header(n: int) -> bytes:
    return struct.pack("B", 0x90 + n) if n <= 15 else _sized(n, (None, 0xDC, 0xDD))


def _map_header(n: int) -> bytes:
    return struct.pack("B", 0x80 + n) if n <= 15 else _sized(n, (None, 0xDE, 0xDF))


def _ext_header(length: int, code: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    head = struct.pack("B", fixed[length]) if length in fixed else _sized(length, (0xC7, 0xC8, 0xC9))
    return head + struct.pack("b", code)


def _is_array(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def _raw(x):
    """(shape, dtype name, flat uint8 numpy view of the C-order bytes)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu").contiguous()
        name = str(t.dtype).split(".")[1]
        if name not in TORCH_DTYPES:
            raise TypeError(f"msgpack: no array encoding for {t.dtype}")
        return tuple(t.shape), name, t.reshape(-1).view(torch.uint8).numpy()
    a = np.asarray(x)
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise TypeError(f"msgpack: no array encoding for {a.dtype}")
    return a.shape, a.dtype.name, a.reshape(-1).view(np.uint8)


def _write_array(write: Callable, x, code: int) -> None:
    shape, name, data = _raw(x)
    inner = bytearray(_array_header(3))
    inner += _array_header(len(shape))
    for d in shape:
        _int(inner.extend, int(d))
    encoded = name.encode()
    inner += _str_header(len(encoded)) + encoded + _bin_header(data.nbytes)
    write(_ext_header(len(inner) + data.nbytes, code))
    write(bytes(inner))
    write(memoryview(data))


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else x.nbytes


def _chunk(x) -> list:
    """flax's _chunk: the (key, value) pairs of a chunked array's map."""
    flat = x.reshape(-1)
    itemsize = x.element_size() if isinstance(x, torch.Tensor) else x.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    chunks = [flat[i:i + size] for i in range(0, flat.shape[0], size)]
    return [(CHUNKED, True), ("shape", {str(i): int(d) for i, d in enumerate(x.shape)}),
            ("chunks", {str(i): c for i, c in enumerate(chunks)})]


def _pack(write: Callable, obj, chunkable: bool, ordered: bool = False) -> None:
    """One object. `chunkable`: reached from the root through maps only
    (where flax chunks large arrays); `ordered`: keep a map's own order."""
    if obj is None:
        write(b"\xc0")
    elif type(obj) is bool:
        write(b"\xc3" if obj else b"\xc2")
    elif type(obj) is int:
        _int(write, obj)
    elif type(obj) is float:
        write(struct.pack(">Bd", 0xCB, obj))
    elif type(obj) is str:
        encoded = obj.encode("utf-8")
        write(_str_header(len(encoded)))
        write(encoded)
    elif type(obj) in (bytes, bytearray):
        write(_bin_header(len(obj)))
        write(bytes(obj))
    elif type(obj) is list:
        write(_array_header(len(obj)))
        for item in obj:
            _pack(write, item, False)
    elif type(obj) is dict:
        write(_map_header(len(obj)))
        for key in (obj if ordered else sorted(obj)):
            if type(key) is not str:
                raise TypeError(f"msgpack: map keys must be strings, got {key!r}")
            _pack(write, key, False)
            _pack(write, obj[key], chunkable, ordered)
    elif _is_array(obj):
        if chunkable and _nbytes(obj) > MAX_CHUNK_SIZE:
            _pack(write, dict(_chunk(obj)), False, ordered=True)
        else:
            _write_array(write, obj, EXT_NDARRAY)
    elif isinstance(obj, np.generic):
        _write_array(write, np.asarray(obj), EXT_NPSCALAR)
    else:
        raise TypeError(f"msgpack: cannot serialize {type(obj).__name__}")


def msgpack_serialize(tree) -> bytes:
    """flax.serialization.msgpack_serialize's bytes for `tree` (nested dicts
    with string keys, lists, scalars, tensors and numpy arrays)."""
    out = bytearray()
    _pack(out.extend, tree, True)
    return bytes(out)


def write_msgpack(path: str, tree) -> None:
    """msgpack_serialize(tree) streamed into `path` through a temporary file,
    so a reader never sees half a file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        _pack(f.write, tree, True)
    os.replace(tmp, path)


# --- reading ------------------------------------------------------------------


_CONSTANTS = {0xC0: None, 0xC2: False, 0xC3: True}
_NUMBERS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
# the length field of each sized type: bin, ext, str, array, map
_LENGTHS = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xC7: ">B", 0xC8: ">H", 0xC9: ">I",
            0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}


class _Reader:
    def __init__(self, buf: memoryview):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError(f"msgpack: truncated data at byte {self.pos}")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        if self.pos + size > len(self.buf):
            raise ValueError(f"msgpack: truncated data at byte {self.pos}")
        (value,) = struct.unpack_from(fmt, self.buf, self.pos)
        self.pos += size
        return value

    def read(self):
        """One object; a bin as a memoryview of the buffer."""
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b <= 0x8F:
            return self.map(b & 0x0F)
        if b <= 0x9F:
            return self.array(b & 0x0F)
        if b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if b in _CONSTANTS:
            return _CONSTANTS[b]
        if b in _NUMBERS:
            return self.unpack(_NUMBERS[b])
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            code = self.unpack("b")
            return self.ext(code, self.take(1 << (b - 0xD4)))
        if b not in _LENGTHS:
            raise ValueError(f"msgpack: unknown type byte 0x{b:02x} at byte {self.pos - 1}")
        n = self.unpack(_LENGTHS[b])
        if b <= 0xC6:
            return self.take(n)
        if b <= 0xC9:
            code = self.unpack("b")
            return self.ext(code, self.take(n))
        if b <= 0xDB:
            return str(self.take(n), "utf-8")
        return self.array(n) if b <= 0xDD else self.map(n)

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def value(self):
        """read() with bins as bytes (only ext payloads stay views)."""
        v = self.read()
        return bytes(v) if isinstance(v, memoryview) else v

    def ext(self, code: int, payload: memoryview):
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack: unknown extension type {code}")
        inner = _Reader(payload)
        if inner.unpack("B") != 0x93:
            raise ValueError("msgpack: an array extension is not (shape, dtype, bytes)")
        shape = inner.value()
        name = inner.read()
        name = str(name, "utf-8") if isinstance(name, memoryview) else name
        data = inner.read()
        if name not in TORCH_DTYPES:
            raise ValueError(f"msgpack: unsupported array dtype {name!r}")
        if code == EXT_NPSCALAR and name != "bfloat16":
            return np.frombuffer(bytes(data), dtype=name).reshape(())[()]
        dtype = TORCH_DTYPES[name]
        t = torch.frombuffer(data, dtype=dtype) if len(data) else torch.empty(0, dtype=dtype)
        return t.reshape(shape)


def _unchunk(tree):
    if isinstance(tree, dict):
        if CHUNKED in tree:
            shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return torch.cat(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unchunk(v) for v in tree]
    return tree


def msgpack_restore(data) -> Any:
    """flax.serialization.msgpack_restore's tree, arrays as CPU tensors that
    view `data` (bytes are copied once into a writable buffer)."""
    buf = data if isinstance(data, bytearray) else bytearray(data)
    reader = _Reader(memoryview(buf))
    tree = reader.value()
    if reader.pos != len(buf):
        raise ValueError(f"msgpack: {len(buf) - reader.pos} bytes after the object")
    return _unchunk(tree)


def read_msgpack(path: str) -> Any:
    buf = bytearray(os.path.getsize(path))
    with open(path, "rb") as f:
        if f.readinto(buf) != len(buf):
            raise ValueError(f"msgpack: short read of {path}")
    return msgpack_restore(buf)


# --- flax's list encoding ---------------------------------------------------------


def to_state_dict(tree):
    """flax to_state_dict: lists (and tuples) -> {"0": ..., "1": ...}."""
    if isinstance(tree, dict):
        return {str(k): to_state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): to_state_dict(v) for i, v in enumerate(tree)}
    return tree


def relistify(tree):
    """Inverse of to_state_dict: a map whose keys are exactly "0".."n-1"
    becomes a list again (the trees use lists only for per-layer stacks)."""
    if isinstance(tree, dict):
        out = {k: relistify(v) for k, v in tree.items()}
        if out and all(k.isdigit() for k in out) and sorted(out, key=int) == [str(i) for i in range(len(out))]:
            return [out[str(i)] for i in range(len(out))]
        return out
    return tree
