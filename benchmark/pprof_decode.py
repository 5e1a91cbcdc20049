"""A small profile.proto decoder, kept here so the check does not read the
agent's own parser: samples, locations, mappings, the string table and
the period, by the public schema's field numbers."""

from __future__ import annotations

import gzip

# profile.proto field numbers.
P_SAMPLE, P_MAPPING, P_LOCATION, P_STRING_TABLE, P_PERIOD = 2, 3, 4, 6, 12
S_LOCATION_ID, S_VALUE = 1, 2
M_ID, M_START, M_LIMIT, M_OFFSET, M_FILENAME, M_BUILDID = 1, 2, 3, 4, 5, 6
LOC_ID, LOC_MAPPING_ID, LOC_ADDRESS = 1, 2, 3


def _varint(buf: bytes, i: int) -> tuple[int, int]:
    shift = value = 0
    while True:
        b = buf[i]
        i += 1
        value |= (b & 0x7F) << shift
        if b < 0x80:
            return value, i
        shift += 7
        if shift > 63:
            raise ValueError("varint longer than 10 bytes")


def fields(buf: bytes):
    """(field number, wire type, int or bytes) of each field of `buf`."""
    i, n = 0, len(buf)
    while i < n:
        tag, i = _varint(buf, i)
        field, wt = tag >> 3, tag & 7
        if wt == 0:
            v, i = _varint(buf, i)
            yield field, wt, v
        elif wt == 2:
            ln, i = _varint(buf, i)
            if i + ln > n:
                raise ValueError("length-delimited field past the end")
            yield field, wt, buf[i:i + ln]
            i += ln
        elif wt == 1:
            yield field, wt, int.from_bytes(buf[i:i + 8], "little")
            i += 8
        elif wt == 5:
            yield field, wt, int.from_bytes(buf[i:i + 4], "little")
            i += 4
        else:
            raise ValueError(f"wire type {wt}")


def _ints(wt: int, v) -> list[int]:
    """A repeated integer field, packed or not."""
    if wt == 0:
        return [v]
    out, i = [], 0
    while i < len(v):
        x, i = _varint(v, i)
        out.append(x)
    return out


def decode(blob) -> dict:
    """{"samples": [(location ids, values)], "locations": {id: (mapping
    id, address)}, "mappings": {id: (start, limit, offset, file, build
    id)}, "period": int}."""
    data = bytes(blob)
    if data[:2] == b"\x1f\x8b":
        data = gzip.decompress(data)
    samples, locations, raw_maps, strings = [], {}, {}, []
    period = 0
    for f, wt, v in fields(data):
        if f == P_SAMPLE:
            ids, vals = [], []
            for sf, swt, sv in fields(v):
                if sf == S_LOCATION_ID:
                    ids.extend(_ints(swt, sv))
                elif sf == S_VALUE:
                    vals.extend(_ints(swt, sv))
            samples.append((tuple(ids), tuple(vals)))
        elif f == P_LOCATION:
            d = {lf: lv for lf, lwt, lv in fields(v) if lwt == 0}
            locations[d.get(LOC_ID, 0)] = (d.get(LOC_MAPPING_ID, 0),
                                           d.get(LOC_ADDRESS, 0))
        elif f == P_MAPPING:
            d = {mf: mv for mf, mwt, mv in fields(v) if mwt == 0}
            raw_maps[d.get(M_ID, 0)] = d
        elif f == P_STRING_TABLE:
            strings.append(bytes(v).decode())
        elif f == P_PERIOD:
            period = v
    mappings = {
        mid: (d.get(M_START, 0), d.get(M_LIMIT, 0), d.get(M_OFFSET, 0),
              strings[d.get(M_FILENAME, 0)], strings[d.get(M_BUILDID, 0)])
        for mid, d in raw_maps.items()}
    return {"samples": samples, "locations": locations,
            "mappings": mappings, "period": period}


def stacks(profile: dict) -> tuple[dict, dict]:
    """({frame keys: count} over samples with a positive count, {mapping
    start: mapping} of the mappings those samples' locations name); a
    frame key is (its mapping's start or 0, its address), leaf first."""
    maps = profile["mappings"]
    locs = profile["locations"]
    out: dict = {}
    used: dict = {}
    for ids, vals in profile["samples"]:
        if not vals or vals[0] <= 0:
            continue
        key = []
        for i in ids:
            mid, addr = locs[i]
            m = maps.get(mid)
            start = m[0] if m is not None else 0
            if m is not None:
                used[start] = m
            key.append((start, addr))
        key = tuple(key)
        out[key] = out.get(key, 0) + vals[0]
    return out, used
