"""Build pprof profile.proto bytes from aggregator tables, and parse back.

Output shape matches the reference's ConvertToPprof (pkg/profiler/pprof.go:
24-72): SampleType = [{samples, count}], PeriodType = {cpu, nanoseconds},
Period = sampling period, one Sample per deduplicated stack with leaf-first
location ids, Mapping/Location/Function tables with 1-based ids. The parser
exists for tests and the live-query path, not for re-serialization.
"""

from __future__ import annotations

import dataclasses
import gzip

from parca_agent_tpu_torch.aggregator.base import PidProfile
from parca_agent_tpu_torch.pprof import proto

# profile.proto field numbers (public schema).
P_SAMPLE_TYPE, P_SAMPLE, P_MAPPING, P_LOCATION, P_FUNCTION = 1, 2, 3, 4, 5
P_STRING_TABLE, P_TIME_NANOS, P_DURATION_NANOS = 6, 9, 10
P_PERIOD_TYPE, P_PERIOD = 11, 12
VT_TYPE, VT_UNIT = 1, 2
S_LOCATION_ID, S_VALUE, S_LABEL = 1, 2, 3
L_KEY, L_STR, L_NUM = 1, 2, 3
M_ID, M_START, M_LIMIT, M_OFFSET, M_FILENAME, M_BUILDID = 1, 2, 3, 4, 5, 6
LOC_ID, LOC_MAPPING_ID, LOC_ADDRESS, LOC_LINE = 1, 2, 3, 4
LINE_FUNCTION_ID, LINE_LINE = 1, 2
F_ID, F_NAME, F_SYSTEM_NAME, F_FILENAME, F_START_LINE = 1, 2, 3, 4, 5


class _Strings:
    """pprof string table: index 0 is always ''."""

    def __init__(self):
        self.table: list[str] = [""]
        self.index: dict[str, int] = {"": 0}

    def __call__(self, s: str) -> int:
        i = self.index.get(s)
        if i is None:
            i = len(self.table)
            self.table.append(s)
            self.index[s] = i
        return i


def build_pprof(
    prof: PidProfile,
    labels: dict[str, str] | None = None,
    compress: bool = True,
) -> bytes:
    """Serialize one PidProfile to (optionally gzipped) profile.proto bytes.

    `labels` become string labels on every sample (the reference instead
    carries target labels beside the profile in the write request; embedding
    them also is harmless and keeps local files self-describing).
    """
    st = _Strings()
    w = proto.Writer()

    vt = proto.Writer().varint(VT_TYPE, st("samples")).varint(VT_UNIT, st("count"))
    w.message(P_SAMPLE_TYPE, vt.buf)

    label_body = bytearray()
    for k, v in (labels or {}).items():
        lw = proto.Writer().varint(L_KEY, st(k)).varint(L_STR, st(v))
        proto.put_tag_bytes(label_body, S_LABEL, bytes(lw.buf))

    ids = prof.stack_loc_ids
    depths = prof.stack_depths
    values = prof.values
    for i in range(len(values)):
        sw = proto.Writer()
        sw.packed(S_LOCATION_ID, ids[i, : int(depths[i])].tolist())
        sw.packed(S_VALUE, [int(values[i])])
        sw.buf.extend(label_body)
        w.message(P_SAMPLE, sw.buf)

    for m in prof.mappings:
        mw = (
            proto.Writer()
            .varint(M_ID, m.id)
            .varint(M_START, m.start)
            .varint(M_LIMIT, m.end)
            .varint(M_OFFSET, m.offset)
            .varint(M_FILENAME, st(m.path))
            .varint(M_BUILDID, st(m.build_id))
        )
        w.message(P_MAPPING, mw.buf)

    loc_lines = prof.loc_lines
    addr = prof.loc_normalized
    for j in range(prof.n_locations):
        lw = (
            proto.Writer()
            .varint(LOC_ID, j + 1)
            .varint(LOC_MAPPING_ID, int(prof.loc_mapping_id[j]))
            .varint(LOC_ADDRESS, int(addr[j]))
        )
        if loc_lines is not None:
            for func_id, line in loc_lines[j]:
                lnw = proto.Writer().varint(LINE_FUNCTION_ID, func_id).varint(
                    LINE_LINE, line
                )
                lw.message(LOC_LINE, lnw.buf)
        w.message(P_LOCATION, lw.buf)

    for fi, (name, system_name, filename, start_line) in enumerate(prof.functions):
        fw = (
            proto.Writer()
            .varint(F_ID, fi + 1)
            .varint(F_NAME, st(name))
            .varint(F_SYSTEM_NAME, st(system_name))
            .varint(F_FILENAME, st(filename))
            .varint(F_START_LINE, start_line)
        )
        w.message(P_FUNCTION, fw.buf)

    # Intern every string before dumping the table: nothing below may call st().
    pt = proto.Writer().varint(VT_TYPE, st("cpu")).varint(VT_UNIT, st("nanoseconds"))
    for s in st.table:
        proto.put_tag_bytes(w.buf, P_STRING_TABLE, s.encode())
    w.varint(P_TIME_NANOS, prof.time_ns)
    w.varint(P_DURATION_NANOS, prof.duration_ns)
    w.message(P_PERIOD_TYPE, pt.buf)
    w.varint(P_PERIOD, prof.period_ns)

    data = w.getvalue()
    return gzip.compress(data, 6) if compress else data


@dataclasses.dataclass
class ParsedProfile:
    sample_types: list[tuple[str, str]]
    period_type: tuple[str, str]
    period: int
    time_nanos: int
    duration_nanos: int
    samples: list[tuple[tuple[int, ...], tuple[int, ...], dict[str, str]]]
    mappings: dict[int, dict]
    locations: dict[int, dict]
    functions: dict[int, dict]
    strings: list[str]

    def stacks_by_address(self) -> dict[tuple[int, ...], int]:
        """{leaf-first normalized-address stack: total count} for assertions."""
        out: dict[tuple[int, ...], int] = {}
        for loc_ids, vals, _ in self.samples:
            key = tuple(self.locations[i]["address"] for i in loc_ids)
            out[key] = out.get(key, 0) + vals[0]
        return out


def parse_pprof(data: bytes) -> ParsedProfile:
    if data[:2] == b"\x1f\x8b":
        data = gzip.decompress(data)
    strings: list[str] = []
    sample_types: list[tuple[int, int]] = []
    period_type = (0, 0)
    period = time_nanos = duration_nanos = 0
    raw_samples: list[tuple[list[int], list[int], list[tuple[int, int]]]] = []
    mappings: dict[int, dict] = {}
    locations: dict[int, dict] = {}
    functions: dict[int, dict] = {}

    def parse_vt(body: bytes) -> tuple[int, int]:
        t = u = 0
        for f, _, v in proto.iter_fields(body):
            if f == VT_TYPE:
                t = v
            elif f == VT_UNIT:
                u = v
        return t, u

    for field, wt, val in proto.iter_fields(data):
        if field == P_STRING_TABLE:
            strings.append(val.decode())
        elif field == P_SAMPLE_TYPE:
            sample_types.append(parse_vt(val))
        elif field == P_PERIOD_TYPE:
            period_type = parse_vt(val)
        elif field == P_PERIOD:
            period = proto.signed(val)
        elif field == P_TIME_NANOS:
            time_nanos = proto.signed(val)
        elif field == P_DURATION_NANOS:
            duration_nanos = proto.signed(val)
        elif field == P_SAMPLE:
            loc_ids: list[int] = []
            values: list[int] = []
            labels: list[tuple[int, int]] = []
            for f, _, v in proto.iter_fields(val):
                if f == S_LOCATION_ID:
                    proto.repeated_scalar(v, loc_ids)
                elif f == S_VALUE:
                    proto.repeated_scalar(v, values)
                elif f == S_LABEL:
                    k = sv = 0
                    for lf, _, lv in proto.iter_fields(v):
                        if lf == L_KEY:
                            k = lv
                        elif lf == L_STR:
                            sv = lv
                    labels.append((k, sv))
            raw_samples.append((loc_ids, values, labels))
        elif field == P_MAPPING:
            m: dict = {}
            for f, _, v in proto.iter_fields(val):
                m[f] = v
            mappings[m.get(M_ID, 0)] = {
                "start": m.get(M_START, 0),
                "limit": m.get(M_LIMIT, 0),
                "offset": m.get(M_OFFSET, 0),
                "filename": m.get(M_FILENAME, 0),
                "build_id": m.get(M_BUILDID, 0),
            }
        elif field == P_LOCATION:
            loc: dict = {"lines": []}
            for f, _, v in proto.iter_fields(val):
                if f == LOC_LINE:
                    fn = ln = 0
                    for lf, _, lv in proto.iter_fields(v):
                        if lf == LINE_FUNCTION_ID:
                            fn = lv
                        elif lf == LINE_LINE:
                            ln = proto.signed(lv)
                    loc["lines"].append((fn, ln))
                else:
                    loc[f] = v
            locations[loc.get(LOC_ID, 0)] = {
                "mapping_id": loc.get(LOC_MAPPING_ID, 0),
                "address": loc.get(LOC_ADDRESS, 0),
                "lines": loc["lines"],
            }
        elif field == P_FUNCTION:
            fn: dict = {}
            for f, _, v in proto.iter_fields(val):
                fn[f] = v
            functions[fn.get(F_ID, 0)] = {
                "name": fn.get(F_NAME, 0),
                "system_name": fn.get(F_SYSTEM_NAME, 0),
                "filename": fn.get(F_FILENAME, 0),
                "start_line": proto.signed(fn.get(F_START_LINE, 0)),
            }

    def s(i) -> str:
        return strings[i] if 0 <= i < len(strings) else ""

    for m in mappings.values():
        m["filename"] = s(m["filename"])
        m["build_id"] = s(m["build_id"])
    for fn in functions.values():
        fn["name"] = s(fn["name"])
        fn["system_name"] = s(fn["system_name"])
        fn["filename"] = s(fn["filename"])

    return ParsedProfile(
        sample_types=[(s(t), s(u)) for t, u in sample_types],
        period_type=(s(period_type[0]), s(period_type[1])),
        period=period,
        time_nanos=time_nanos,
        duration_nanos=duration_nanos,
        samples=[
            (tuple(l), tuple(proto.signed(v) for v in vals),
             {s(k): s(v) for k, v in labels})
            for l, vals, labels in raw_samples
        ],
        mappings=mappings,
        locations=locations,
        functions=functions,
        strings=strings,
    )
