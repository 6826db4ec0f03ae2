"""Reading and writing the msgpack subset that flax's ``msgpack_serialize``
writes, in pure Python (no ``msgpack``, no ``flax``).

Counterpart of ``flax.serialization.msgpack_restore`` /
``msgpack_serialize``, the calls turkish_asr_tpu/train/checkpoint.py:41-57
and :83-96 make for the JAX package's ``.ckpt`` files. The subset:

- nil, bool, positive and negative ints of every width, float32/float64,
  str, bin, array (-> list), map (-> dict);
- ext type 1, an array: a nested msgpack ``(shape, dtype name, C-order
  bytes)``. It becomes a numpy array over the file's bytes (no copy), or,
  for ``bfloat16``, which numpy lacks, a ``torch.bfloat16`` tensor (its
  bytes copied once, as int16, then viewed as bf16);
- ext type 3, a numpy scalar: the same payload, returned as ``arr[()]``
  (a bfloat16 scalar as a 0-d bf16 tensor);
- ext type 2, a complex as a nested ``(real, imag)``.

flax splits an array over 2^30 bytes into ``{"__msgpack_chunked_array__":
True, "shape": {"0": ...}, "chunks": {"0": ...}}``; ``unpackb``
reassembles it, as ``msgpack_restore`` does. Any other ext code, or a byte
that starts no value of the format, raises ``ValueError``.

``packb`` writes the subset a checkpoint needs (ints in their shortest
form, floats as float64, tuples as arrays, numpy arrays and tensors as
ext 1, numpy scalars as ext 3); it refuses an array over
``MAX_CHUNK_SIZE`` bytes, which flax would write in chunks.
"""

import struct

import numpy as np
import torch

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
MAX_CHUNK_SIZE = 2 ** 30  # flax's: msgpack caps an object at 2^31 - 1 bytes
CHUNKED = "__msgpack_chunked_array__"

_FIXED = {  # first byte -> (struct format, size) of fixed-width scalars
    0xca: (">f", 4), 0xcb: (">d", 8),
    0xcc: (">B", 1), 0xcd: (">H", 2), 0xce: (">I", 4), 0xcf: (">Q", 8),
    0xd0: (">b", 1), 0xd1: (">h", 2), 0xd2: (">i", 4), 0xd3: (">q", 8),
}
_LENGTH = {1: ">B", 2: ">H", 4: ">I"}


class _Reader:
    """A cursor over one buffer; ``value()`` decodes the next object."""

    def __init__(self, buf):
        self.buf = memoryview(buf).cast("B")
        self.pos = 0

    def _take(self, n):
        if self.pos + n > len(self.buf):
            raise ValueError(f"msgpack data ends inside an object (at byte {self.pos}, "
                             f"{n} more needed, {len(self.buf) - self.pos} left)")
        view = self.buf[self.pos:self.pos + n]
        self.pos += n
        return view

    def _uint(self, size):
        return struct.unpack(_LENGTH[size], self._take(size))[0]

    def value(self, raw_bin=False):
        b = self._take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self._map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self._array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return str(self._take(b & 0x1f), "utf-8")
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in _FIXED:
            fmt, size = _FIXED[b]
            return struct.unpack(fmt, self._take(size))[0]
        if 0xc4 <= b <= 0xc6:  # bin 8/16/32
            data = self._take(self._uint(1 << (b - 0xc4)))
            return data if raw_bin else bytes(data)
        if 0xd9 <= b <= 0xdb:  # str 8/16/32
            return str(self._take(self._uint(1 << (b - 0xd9))), "utf-8")
        if b in (0xdc, 0xdd):
            return self._array(self._uint(2 if b == 0xdc else 4))
        if b in (0xde, 0xdf):
            return self._map(self._uint(2 if b == 0xde else 4))
        if 0xd4 <= b <= 0xd8:  # fixext 1/2/4/8/16
            return self._ext(1 << (b - 0xd4))
        if 0xc7 <= b <= 0xc9:  # ext 8/16/32
            return self._ext(self._uint(1 << (b - 0xc7)))
        raise ValueError(f"byte 0x{b:02x} at {self.pos - 1} starts no msgpack object")

    def _array(self, n):
        return [self.value() for _ in range(n)]

    def _map(self, n):
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def _ext(self, n):
        code = struct.unpack(">b", self._take(1))[0]
        data = self._take(n)
        if code == EXT_NDARRAY:
            return _array_from_payload(data)
        if code == EXT_NPSCALAR:
            arr = _array_from_payload(data)
            return arr[()] if isinstance(arr, np.ndarray) else arr
        if code == EXT_COMPLEX:
            real, imag = _Reader(data).value()
            return complex(real, imag)
        raise ValueError(f"msgpack ext type {code} is not one flax writes (1, 2, 3)")


def _array_from_payload(data):
    reader = _Reader(data)
    if reader._take(1)[0] != 0x93:
        raise ValueError("array payload is not a 3-element msgpack array")
    shape, name, buf = reader.value(), reader.value(), reader.value(raw_bin=True)
    if not (isinstance(shape, list) and isinstance(name, str) and isinstance(buf, memoryview)):
        raise ValueError("array payload is not (shape, dtype name, bytes)")
    shape = tuple(int(s) for s in shape)
    if name == "bfloat16":
        flat = np.frombuffer(buf, dtype=np.int16)
        return torch.from_numpy(flat.copy()).view(torch.bfloat16).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)


def _unchunk(tree):
    if isinstance(tree, dict):
        if tree.get(CHUNKED) is True:
            shape = tuple(int(tree["shape"][str(i)]) for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            if any(isinstance(c, torch.Tensor) for c in chunks):
                return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
            return np.concatenate([np.asarray(c).reshape(-1) for c in chunks]).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unchunk(v) for v in tree]
    return tree


def unpackb(buf):
    """The object in ``buf`` (bytes, bytearray or memoryview), as
    ``flax.serialization.msgpack_restore`` returns it. Arrays are
    read-only views of ``buf`` where numpy can hold them."""
    reader = _Reader(buf)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} bytes after the msgpack object")
    return _unchunk(out)


# ---------------------------------------------------------------------------
# writer


def _pack_uint(out, n, small, prefixes):
    """A length or count: in ``small``'s fix form when below its limit,
    else the shortest of the 8/16/32-bit forms ``prefixes`` name."""
    if small is not None and n < small[1]:
        out.append(small[0] | n)
        return
    for size, prefix in prefixes:
        if prefix is not None and n < 1 << (8 * size):
            out.append(prefix)
            out += struct.pack(_LENGTH[size], n)
            return
    raise ValueError(f"msgpack object too long: {n}")


def _pack_int(out, v):
    if 0 <= v <= 0x7f:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xff)
    elif v >= 0:
        for code, fmt, limit in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                                 (0xce, ">I", 1 << 32), (0xcf, ">Q", 1 << 64)):
            if v < limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f"int {v} does not fit msgpack's 64 bits")
    else:
        for code, fmt, limit in ((0xd0, ">b", 1 << 7), (0xd1, ">h", 1 << 15),
                                 (0xd2, ">i", 1 << 31), (0xd3, ">q", 1 << 63)):
            if v >= -limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f"int {v} does not fit msgpack's 64 bits")


def _array_payload(arr):
    """The ext 1 payload of a numpy array or a CPU tensor."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            shape, name, data = tuple(t.shape), "bfloat16", t.view(torch.int16).numpy().tobytes()
        else:
            a = t.numpy()
            shape, name, data = a.shape, a.dtype.name, a.tobytes("C")
    else:
        if arr.dtype.hasobject or arr.dtype.fields is not None:
            raise ValueError("object and structured arrays are not serializable")
        shape, name, data = arr.shape, arr.dtype.name, arr.tobytes("C")
    out = bytearray()
    _pack(out, [list(shape), name, data])
    return bytes(out)


def _pack_ext(out, code, payload):
    n = len(payload)
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        out.append(fixed[n])
    else:
        _pack_uint(out, n, None, ((1, 0xc7), (2, 0xc8), (4, 0xc9)))
    out += struct.pack(">b", code)
    out += payload


def _nbytes(arr):
    return arr.numel() * arr.element_size() if isinstance(arr, torch.Tensor) else arr.nbytes


def _pack(out, v):
    if v is None:
        out.append(0xc0)
    elif v is True or v is False:
        out.append(0xc3 if v else 0xc2)
    elif isinstance(v, (np.ndarray, torch.Tensor)):
        if _nbytes(v) > MAX_CHUNK_SIZE:
            raise ValueError(f"array of {_nbytes(v)} bytes: the writer takes arrays up to "
                             f"{MAX_CHUNK_SIZE} bytes (flax would split it into chunks)")
        _pack_ext(out, EXT_NDARRAY, _array_payload(v))
    elif isinstance(v, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _array_payload(np.asarray(v)))
    elif isinstance(v, int):
        _pack_int(out, v)
    elif isinstance(v, float):
        out.append(0xcb)
        out += struct.pack(">d", v)
    elif isinstance(v, str):
        data = v.encode("utf-8")
        _pack_uint(out, len(data), (0xa0, 32), ((1, 0xd9), (2, 0xda), (4, 0xdb)))
        out += data
    elif isinstance(v, (bytes, bytearray, memoryview)):
        data = bytes(v)
        _pack_uint(out, len(data), None, ((1, 0xc4), (2, 0xc5), (4, 0xc6)))
        out += data
    elif isinstance(v, (list, tuple)):
        _pack_uint(out, len(v), (0x90, 16), ((1, None), (2, 0xdc), (4, 0xdd)))
        for x in v:
            _pack(out, x)
    elif isinstance(v, dict):
        _pack_uint(out, len(v), (0x80, 16), ((1, None), (2, 0xde), (4, 0xdf)))
        for k, x in v.items():
            _pack(out, k)
            _pack(out, x)
    else:
        raise TypeError(f"cannot msgpack-serialize {type(v).__name__}")


def packb(obj):
    """``obj`` as msgpack bytes that ``flax.serialization.msgpack_restore``
    reads back."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)
