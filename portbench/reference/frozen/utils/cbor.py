"""Minimal canonical CBOR (RFC 8949 subset) codec.

The reference CBOR-encodes inputs host→guest with ``serde_cbor``
(src/main.rs:435,459): structs become definite-length maps with text keys in
field-declaration order, raw byte newtypes serialize as hex *text* strings
(their custom serde impl), integers as the shortest unsigned encoding.
This codec reproduces those bytes exactly for the value shapes the framework
uses (maps, arrays, text, unsigned ints, byte strings) so that proof
transcripts hashing the input stream are stable.
"""

from __future__ import annotations


class CborError(ValueError):
    pass


def _head(major: int, arg: int) -> bytes:
    if arg < 24:
        return bytes([(major << 5) | arg])
    if arg < 1 << 8:
        return bytes([(major << 5) | 24, arg])
    if arg < 1 << 16:
        return bytes([(major << 5) | 25]) + arg.to_bytes(2, "big")
    if arg < 1 << 32:
        return bytes([(major << 5) | 26]) + arg.to_bytes(4, "big")
    return bytes([(major << 5) | 27]) + arg.to_bytes(8, "big")


def encode(value) -> bytes:
    out = bytearray()
    _encode(value, out)
    return bytes(out)


def _encode(value, out: bytearray) -> None:
    if value is None:
        out.append(0xF6)
    elif value is True:
        out.append(0xF5)
    elif value is False:
        out.append(0xF4)
    elif isinstance(value, int):
        if value >= 0:
            out += _head(0, value)
        else:
            out += _head(1, -1 - value)
    elif isinstance(value, bytes):
        out += _head(2, len(value))
        out += value
    elif isinstance(value, str):
        b = value.encode("utf-8")
        out += _head(3, len(b))
        out += b
    elif isinstance(value, (list, tuple)):
        out += _head(4, len(value))
        for item in value:
            _encode(item, out)
    elif isinstance(value, dict):
        out += _head(5, len(value))
        for k, v in value.items():  # insertion order == struct declaration order
            _encode(k, out)
            _encode(v, out)
    else:
        raise CborError(f"unsupported CBOR value type: {type(value)!r}")


def decode(data: bytes):
    value, pos = _decode(memoryview(data), 0)
    if pos != len(data):
        raise CborError(f"trailing bytes after CBOR value: {len(data) - pos}")
    return value


def _read_arg(buf, pos, info):
    if info < 24:
        return info, pos
    if info == 24:
        if pos >= len(buf):
            raise CborError("truncated")
        return buf[pos], pos + 1
    if info == 25:
        return int.from_bytes(buf[pos : pos + 2], "big"), pos + 2
    if info == 26:
        return int.from_bytes(buf[pos : pos + 4], "big"), pos + 4
    if info == 27:
        return int.from_bytes(buf[pos : pos + 8], "big"), pos + 8
    raise CborError(f"unsupported additional info {info}")


def _decode(buf, pos):
    if pos >= len(buf):
        raise CborError("truncated CBOR")
    initial = buf[pos]
    pos += 1
    major, info = initial >> 5, initial & 0x1F
    if major == 0:
        return _read_arg(buf, pos, info)
    if major == 1:
        arg, pos = _read_arg(buf, pos, info)
        return -1 - arg, pos
    if major == 2:
        n, pos = _read_arg(buf, pos, info)
        if pos + n > len(buf):
            raise CborError("truncated byte string")
        return bytes(buf[pos : pos + n]), pos + n
    if major == 3:
        n, pos = _read_arg(buf, pos, info)
        if pos + n > len(buf):
            raise CborError("truncated text string")
        return bytes(buf[pos : pos + n]).decode("utf-8"), pos + n
    if major == 4:
        n, pos = _read_arg(buf, pos, info)
        items = []
        for _ in range(n):
            item, pos = _decode(buf, pos)
            items.append(item)
        return items, pos
    if major == 5:
        n, pos = _read_arg(buf, pos, info)
        obj = {}
        for _ in range(n):
            k, pos = _decode(buf, pos)
            v, pos = _decode(buf, pos)
            obj[k] = v
        return obj, pos
    if major == 7:
        if info == 20:
            return False, pos
        if info == 21:
            return True, pos
        if info == 22:
            return None, pos
        raise CborError(f"unsupported simple value {info}")
    raise CborError(f"unsupported major type {major}")
