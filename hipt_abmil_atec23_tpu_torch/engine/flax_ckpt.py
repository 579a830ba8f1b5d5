"""Flax ``.msgpack`` checkpoints, read and written without flax or msgpack.

The JAX package saves a MIL head as ``flax.serialization.to_bytes(params)``
(hipt_abmil_atec23_tpu/engine/checkpoint.py:21-29): a msgpack map of maps
with string keys, in the tree's own key order, whose leaves are

- ext type 1, an ndarray: the msgpack array ``(shape, dtype name, raw C
  bytes)``;
- ext type 3, a numpy scalar, packed as a 0-d ndarray;
- plain msgpack ints, floats, strings, booleans and nil.

(flax splits an array past 2**30 bytes into chunks; no MIL head or train
state comes near that, so neither side here handles it.) This module is the
format in pure Python (``struct``), so hosts without the ``msgpack``
package (the card machine) read and write it. ``to_bytes`` gives
``flax.serialization.to_bytes``'s bytes for a tree of dicts (a state dict,
as ``to_state_dict`` makes one), numpy arrays and scalars; ``from_bytes``
gives ``msgpack_restore``'s tree of dicts and numpy arrays.
"""
from __future__ import annotations

import os
import struct
from typing import Any, Mapping

import numpy as np

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


# --------------------------------------------------------------------------
# writer
# --------------------------------------------------------------------------

def _pack_int(x: int, out: bytearray) -> None:
    if 0 <= x < 0x80:
        out.append(x)
    elif -0x20 <= x < 0:
        out += struct.pack("b", x)
    elif 0 <= x <= 0xFF:
        out += b"\xcc" + struct.pack(">B", x)
    elif -0x80 <= x < 0:
        out += b"\xd0" + struct.pack(">b", x)
    elif 0 <= x <= 0xFFFF:
        out += b"\xcd" + struct.pack(">H", x)
    elif -0x8000 <= x < 0:
        out += b"\xd1" + struct.pack(">h", x)
    elif 0 <= x <= 0xFFFFFFFF:
        out += b"\xce" + struct.pack(">I", x)
    elif -0x80000000 <= x < 0:
        out += b"\xd2" + struct.pack(">i", x)
    elif 0 <= x <= 0xFFFFFFFFFFFFFFFF:
        out += b"\xcf" + struct.pack(">Q", x)
    elif -0x8000000000000000 <= x < 0:
        out += b"\xd3" + struct.pack(">q", x)
    else:
        raise OverflowError(f"int {x} does not fit msgpack")


def _pack_len(n: int, out: bytearray, fix: int, fix_max: int,
              codes) -> None:
    """A header of a str / bin / array / map of length ``n``: the fix form
    below ``fix_max`` (when the type has one), else the 8 / 16 / 32-bit
    length forms ``codes`` (None where the type has no such form)."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"length {n} does not fit msgpack")


def _pack_str(s: str, out: bytearray) -> None:
    b = s.encode("utf-8")
    _pack_len(len(b), out, 0xA0, 31, (0xD9, 0xDA, 0xDB))
    out += b


def _pack_bin(b: bytes, out: bytearray) -> None:
    _pack_len(len(b), out, None, 0, (0xC4, 0xC5, 0xC6))
    out += b


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    n = len(data)
    if n in fixed:
        out.append(fixed[n])
    else:
        _pack_len(n, out, None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack("b", code)
    out += data


def _ndarray_bytes(a: np.ndarray) -> bytes:
    """flax's ``_ndarray_to_bytes``: packb((shape, dtype name, C bytes))
    with tuples as arrays."""
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes do not serialize")
    out = bytearray()
    out.append(0x93)
    _pack_len(a.ndim, out, 0x90, 15, (None, 0xDC, 0xDD))
    for s in a.shape:
        _pack_int(int(s), out)
    _pack_str(a.dtype.name, out)
    _pack_bin(a.tobytes("C"), out)
    return bytes(out)


def _pack(x: Any, out: bytearray) -> None:
    if x is None:
        out.append(0xC0)
    elif x is True:
        out.append(0xC3)
    elif x is False:
        out.append(0xC2)
    elif type(x) is int:
        _pack_int(x, out)
    elif type(x) is float:
        out += b"\xcb" + struct.pack(">d", x)
    elif type(x) is str:
        _pack_str(x, out)
    elif type(x) is bytes:
        _pack_bin(x, out)
    elif isinstance(x, Mapping):
        _pack_len(len(x), out, 0x80, 15, (None, 0xDE, 0xDF))
        for k in x:
            _pack_str(str(k), out)
            _pack(x[k], out)
    elif isinstance(x, np.ndarray):
        _pack_ext(_EXT_NDARRAY, _ndarray_bytes(x), out)
    elif isinstance(x, np.generic):
        _pack_ext(_EXT_NPSCALAR, _ndarray_bytes(np.asarray(x)), out)
    else:
        raise TypeError(f"cannot serialize {type(x).__name__}")


def to_bytes(tree: Any) -> bytes:
    """``flax.serialization.to_bytes(tree)`` for a state dict: string-keyed
    mappings of numpy arrays and scalars and Python scalars."""
    out = bytearray()
    _pack(tree, out)
    return bytes(out)


# --------------------------------------------------------------------------
# reader
# --------------------------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in lengths:
            return bytes(self.take(self.unpack(lengths[b])))
        ext_lengths = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in ext_lengths:
            n = self.unpack(ext_lengths[b])
            return self.ext(self.unpack("b"), bytes(self.take(n)))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            code = self.unpack("b")
            return self.ext(code, bytes(self.take(fixext[b])))
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in strs:
            return str(self.take(self.unpack(strs[b])), "utf-8")
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")

    def array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    @staticmethod
    def ext(code: int, data: bytes) -> Any:
        if code == _EXT_NDARRAY:
            return _ndarray_from_bytes(data)
        if code == _EXT_NPSCALAR:
            return _ndarray_from_bytes(data)[()]
        raise ValueError(f"msgpack ext type {code} is not a flax array")


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    shape, name, raw = _Reader(data).read()
    return np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape).copy()


def from_bytes(data: bytes) -> Any:
    """The tree of a flax msgpack file: ``flax.serialization.
    msgpack_restore``'s dicts and numpy arrays."""
    r = _Reader(data)
    tree = r.read()
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after the msgpack object")
    return tree


def save_params(path: str, tree: Any) -> None:
    """``to_bytes(tree)`` at ``path`` (the JAX package's save_params)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(to_bytes(tree))


def load_params(path: str) -> Any:
    """The tree that the JAX package's save_params wrote at ``path``."""
    with open(path, "rb") as f:
        return from_bytes(f.read())
