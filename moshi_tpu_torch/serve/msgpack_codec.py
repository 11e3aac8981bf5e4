"""The MessagePack codec of the speech-to-text protocol, without the
`msgpack` package (the card's machine has none; the port reads and writes
safetensors the same way, utils/safetensors.py).

It covers what the protocol sends both ways: maps, arrays (lists and
tuples), strings, bytes (bin), ints, bools, nil and floats.  `packb`
writes what `msgpack.packb(obj, use_single_float=True)` writes: every
float as a float32, every int and every length in its smallest form, str
as str, bytes as bin.  `unpackb` reads what `msgpack.unpackb` reads by
default: str as str, bin as bytes, arrays as lists, float32 and float64
as Python floats; extension types are refused.
"""

import struct


def packb(obj) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack(obj, out: bytearray):
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(0xCA)
        out += struct.pack(">f", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), out, 0xA0, 32, 0xD9, 0xDA, 0xDB)
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(len(data), out, None, 0, 0xC4, 0xC5, 0xC6)
        out += data
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), out, 0x90, 16, None, 0xDC, 0xDD)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), out, 0x80, 16, None, 0xDE, 0xDF)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def _pack_len(n: int, out: bytearray, fix, fix_limit: int, b8, b16, b32):
    if fix is not None and n < fix_limit:
        out.append(fix | n)
    elif b8 is not None and n < 1 << 8:
        out += bytes((b8, n))
    elif n < 1 << 16:
        out.append(b16)
        out += struct.pack(">H", n)
    elif n < 1 << 32:
        out.append(b32)
        out += struct.pack(">I", n)
    else:
        raise ValueError(f"a length of {n} does not fit MessagePack")


def _pack_int(v: int, out: bytearray):
    if 0 <= v < 0x80 or -32 <= v < 0:
        out += struct.pack(">b", v) if v < 0 else bytes((v,))
    elif v >= 0:
        for code, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                 (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"{v} does not fit MessagePack")
    else:
        for code, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                 (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if v >= -limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"{v} does not fit MessagePack")


def unpackb(data: bytes):
    """One object from `data`; ValueError when the bytes are not exactly
    one well-formed object."""
    data = bytes(data)
    try:
        obj, end = _unpack(data, 0)
    except (IndexError, struct.error) as e:
        raise ValueError(f"truncated MessagePack data: {e}") from None
    if end != len(data):
        raise ValueError(f"{len(data) - end} bytes after the MessagePack object")
    return obj


# fixed-size heads: code -> (struct format, size)
_SCALARS = {0xCA: (">f", 4), 0xCB: (">d", 8), 0xCC: (">B", 1), 0xCD: (">H", 2),
            0xCE: (">I", 4), 0xCF: (">Q", 8), 0xD0: (">b", 1), 0xD1: (">h", 2),
            0xD2: (">i", 4), 0xD3: (">q", 8)}
# length-prefixed heads: code -> (kind, length format, size)
_SIZED = {0xC4: ("bin", ">B", 1), 0xC5: ("bin", ">H", 2), 0xC6: ("bin", ">I", 4),
          0xD9: ("str", ">B", 1), 0xDA: ("str", ">H", 2), 0xDB: ("str", ">I", 4),
          0xDC: ("array", ">H", 2), 0xDD: ("array", ">I", 4),
          0xDE: ("map", ">H", 2), 0xDF: ("map", ">I", 4)}


def _unpack(data: bytes, i: int):
    code = data[i]
    i += 1
    if code < 0x80:
        return code, i
    if code >= 0xE0:
        return code - 0x100, i
    if code < 0x90:
        return _unpack_map(data, i, code & 0x0F)
    if code < 0xA0:
        return _unpack_array(data, i, code & 0x0F)
    if code < 0xC0:
        return _unpack_str(data, i, code & 0x1F)
    if code == 0xC0:
        return None, i
    if code in (0xC2, 0xC3):
        return code == 0xC3, i
    if code in _SCALARS:
        fmt, size = _SCALARS[code]
        return struct.unpack_from(fmt, data, i)[0], i + size
    if code in _SIZED:
        kind, fmt, size = _SIZED[code]
        n = struct.unpack_from(fmt, data, i)[0]
        i += size
        if kind == "bin":
            if i + n > len(data):
                raise ValueError("truncated MessagePack bin")
            return data[i:i + n], i + n
        if kind == "str":
            return _unpack_str(data, i, n)
        return (_unpack_array if kind == "array" else _unpack_map)(data, i, n)
    raise ValueError(f"MessagePack code 0x{code:02x} is not supported")


def _unpack_str(data: bytes, i: int, n: int):
    if i + n > len(data):
        raise ValueError("truncated MessagePack str")
    return data[i:i + n].decode("utf-8"), i + n


def _unpack_array(data: bytes, i: int, n: int):
    out = []
    for _ in range(n):
        v, i = _unpack(data, i)
        out.append(v)
    return out, i


def _unpack_map(data: bytes, i: int, n: int):
    out = {}
    for _ in range(n):
        k, i = _unpack(data, i)
        if not isinstance(k, (str, bytes)):
            raise ValueError(f"a map key of type {type(k).__name__}")
        v, i = _unpack(data, i)
        out[k] = v
    return out, i
