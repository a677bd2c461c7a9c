"""A msgpack encoder and decoder for checkpoint manifests (no JAX
counterpart module: the JAX package calls the `msgpack` package, which the
port does not depend on).

It covers exactly the types a manifest holds: dicts with str keys, lists
(and tuples, encoded as arrays), str, int, float, bool and None. `packb`
gives the bytes `msgpack.packb` gives with its defaults: floats as float64,
every int in its smallest encoding (positive and negative fixint, uint8 to
uint64, int8 to int64), str as fixstr, str8, str16 or str32, arrays as
fixarray, array16 or array32, maps as fixmap, map16 or map32, dict entries
in insertion order. `unpackb` reads the same set back, as dicts and
lists, so a manifest written by either package reads in the other.

Truncated, garbled or trailing bytes raise `MsgpackError`, and so does an
unsupported type on either side.
"""

from __future__ import annotations

import struct


class MsgpackError(ValueError):
    """Bytes that are not one complete msgpack value of the manifest's
    types, or a value outside those types."""


def _pack_int(x: int, out: bytearray) -> None:
    if 0 <= x < 0x80:
        out.append(x)
    elif -32 <= x < 0:
        out.append(x & 0xFF)
    elif x >= 0:
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if x < top:
                out.append(code)
                out += struct.pack(fmt, x)
                return
        raise MsgpackError(f"int {x} does not fit 64 bits")
    else:
        for code, fmt, low in ((0xD0, ">b", -(1 << 7)),
                               (0xD1, ">h", -(1 << 15)),
                               (0xD2, ">i", -(1 << 31)),
                               (0xD3, ">q", -(1 << 63))):
            if x >= low:
                out.append(code)
                out += struct.pack(fmt, x)
                return
        raise MsgpackError(f"int {x} does not fit 64 bits")


def _pack_len(n: int, fix: int, fix_max: int, codes: tuple,
              out: bytearray) -> None:
    """A length header: the fix form below `fix_max`, then each
    (code, struct format, limit) in turn."""
    if n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, top in codes:
        if n < top:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise MsgpackError(f"length {n} too large")


_STR = ((0xD9, ">B", 1 << 8), (0xDA, ">H", 1 << 16), (0xDB, ">I", 1 << 32))
_ARRAY = ((0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32))
_MAP = ((0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32))


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xA0, 32, _STR, out)
        out += data
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, _ARRAY, out)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, _MAP, out)
        for key, value in obj.items():
            if not isinstance(key, str):
                raise MsgpackError(f"map key {key!r} is not a str")
            _pack(key, out)
            _pack(value, out)
    else:
        raise MsgpackError(f"cannot pack {type(obj).__name__}")


def packb(obj) -> bytes:
    """`obj` as msgpack bytes, equal to `msgpack.packb(obj)`."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise MsgpackError("Unpack failed: incomplete input")
        chunk = self.data[self.pos:end]
        self.pos = end
        return chunk

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def text(self, n: int) -> str:
        try:
            return str(self.take(n), "utf-8")
        except UnicodeDecodeError as exc:
            raise MsgpackError(f"invalid utf-8 in a str: {exc}") from None


#: fixed-size scalars: code -> struct format
_SCALARS = {0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
#: length-prefixed containers: code -> (kind, struct format of the length)
_SIZED = {0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
          0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
          0xDE: ("map", ">H"), 0xDF: ("map", ">I")}


def _unpack(r: _Reader, depth: int):
    if depth > 512:
        raise MsgpackError("nesting deeper than 512")
    code = r.take(1)[0]
    if code < 0x80:
        return code
    if code >= 0xE0:
        return code - 0x100
    if code in _SCALARS:
        return r.unpack(_SCALARS[code])
    if code in (0xC0, 0xC2, 0xC3):
        return {0xC0: None, 0xC2: False, 0xC3: True}[code]
    if 0xA0 <= code < 0xC0:
        kind, n = "str", code & 0x1F
    elif 0x90 <= code < 0xA0:
        kind, n = "array", code & 0x0F
    elif 0x80 <= code < 0x90:
        kind, n = "map", code & 0x0F
    elif code in _SIZED:
        kind, fmt = _SIZED[code]
        n = r.unpack(fmt)
    else:
        raise MsgpackError(f"unsupported msgpack type byte 0x{code:02x}")
    if kind == "str":
        return r.text(n)
    if n > len(r.data) - r.pos:      # each item takes a byte at least
        raise MsgpackError("Unpack failed: incomplete input")
    if kind == "array":
        return [_unpack(r, depth + 1) for _ in range(n)]
    out = {}
    for _ in range(n):
        key = _unpack(r, depth + 1)
        if not isinstance(key, str):
            raise MsgpackError(f"map key {key!r} is not a str")
        out[key] = _unpack(r, depth + 1)
    return out


def unpackb(data: bytes):
    """The one msgpack value `data` holds; raises MsgpackError for
    truncated, garbled or trailing bytes."""
    r = _Reader(bytes(data))
    obj = _unpack(r, 0)
    if r.pos != len(r.data):
        raise MsgpackError(f"{len(r.data) - r.pos} bytes of extra data "
                           "after the value")
    return obj
