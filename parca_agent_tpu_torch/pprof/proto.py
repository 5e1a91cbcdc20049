"""Minimal protobuf wire-format codec for pprof's profile.proto.

Implements exactly the subset the pprof schema needs: varint, 64-bit and
length-delimited wire types, packed repeated scalars, and embedded messages.
Field numbers follow the public profile.proto schema (the observable wire
contract of the reference's output, pkg/profiler/pprof.go).
"""

from __future__ import annotations

from typing import Iterator


def put_varint(out: bytearray, v: int) -> None:
    if v < 0:
        v &= (1 << 64) - 1  # int64 two's-complement per proto spec
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def get_varint(data: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(data):
            raise ValueError("truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result & ((1 << 64) - 1), pos
        shift += 7
        if shift >= 64:
            raise ValueError("varint too long")


def signed(v: int) -> int:
    """Interpret a decoded uint64 as int64."""
    return v - (1 << 64) if v >= (1 << 63) else v


def tag(field: int, wire_type: int) -> int:
    return (field << 3) | wire_type


def put_tag_varint(out: bytearray, field: int, v: int) -> None:
    if v == 0:
        return  # proto3 default elision
    put_varint(out, tag(field, 0))
    put_varint(out, v)


def put_tag_bytes(out: bytearray, field: int, data: bytes) -> None:
    put_varint(out, tag(field, 2))
    put_varint(out, len(data))
    out.extend(data)


def put_packed(out: bytearray, field: int, values) -> None:
    """Packed repeated varint field (proto3 default for scalars)."""
    body = bytearray()
    for v in values:
        put_varint(body, int(v))
    if body:
        put_tag_bytes(out, field, bytes(body))


def iter_fields(data: bytes) -> Iterator[tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) over a serialized message.

    wire_type 0 -> int, 1 -> 8 raw bytes, 2 -> bytes, 5 -> 4 raw bytes.
    """
    pos = 0
    while pos < len(data):
        key, pos = get_varint(data, pos)
        field, wt = key >> 3, key & 7
        if wt == 0:
            v, pos = get_varint(data, pos)
            yield field, wt, v
        elif wt == 2:
            ln, pos = get_varint(data, pos)
            if pos + ln > len(data):
                raise ValueError("truncated length-delimited field")
            yield field, wt, data[pos : pos + ln]
            pos += ln
        elif wt == 1:
            if pos + 8 > len(data):
                raise ValueError("truncated fixed64 field")
            yield field, wt, data[pos : pos + 8]
            pos += 8
        elif wt == 5:
            if pos + 4 > len(data):
                raise ValueError("truncated fixed32 field")
            yield field, wt, data[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")


def unpack_varints(blob: bytes) -> list[int]:
    out = []
    pos = 0
    while pos < len(blob):
        v, pos = get_varint(blob, pos)
        out.append(v)
    return out


def repeated_scalar(values_or_blob, acc: list[int]) -> None:
    """Accumulate a repeated scalar that may arrive packed or one-by-one."""
    if isinstance(values_or_blob, bytes):
        acc.extend(unpack_varints(values_or_blob))
    else:
        acc.append(values_or_blob)


class Writer:
    """Streamed message writer with length-prefixed submessages."""

    def __init__(self):
        self.buf = bytearray()

    def varint(self, field: int, v: int) -> "Writer":
        put_tag_varint(self.buf, field, v)
        return self

    def message(self, field: int, body: bytes | bytearray) -> "Writer":
        put_tag_bytes(self.buf, field, bytes(body))
        return self

    def packed(self, field: int, values) -> "Writer":
        put_packed(self.buf, field, values)
        return self

    def getvalue(self) -> bytes:
        return bytes(self.buf)
