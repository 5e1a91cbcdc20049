"""Parca profilestore wire format (WriteRawRequest).

Hand-rolled protobuf encode/decode for the gRPC method the agent ships
profiles over (reference: parca profilestore v1alpha1, used by
pkg/agent/batch_remote_write_client.go). Schema subset:

  WriteRawRequest  { string tenant = 1; repeated RawProfileSeries series = 2;
                     bool normalized = 3; }
  RawProfileSeries { LabelSet labels = 1; repeated RawSample samples = 2; }
  LabelSet         { repeated Label labels = 1; }
  Label            { string name = 1; string value = 2; }
  RawSample        { bytes raw_profile = 1; }

The port's copy of parca_agent_tpu's agent/profilestore.py.
"""

from __future__ import annotations

import dataclasses

from parca_agent_tpu_torch.pprof.proto import (
    get_varint,
    iter_fields,
    put_tag_bytes,
    put_tag_varint,
)


@dataclasses.dataclass
class RawSeries:
    labels: dict[str, str]
    samples: list[bytes]  # gzipped pprof protos

    def key(self) -> tuple:
        return tuple(sorted(self.labels.items()))


def _encode_label(name: str, value: str) -> bytes:
    out = bytearray()
    put_tag_bytes(out, 1, name.encode())
    put_tag_bytes(out, 2, value.encode())
    return bytes(out)


def _encode_labelset(labels: dict[str, str]) -> bytes:
    out = bytearray()
    for name in sorted(labels):
        put_tag_bytes(out, 1, _encode_label(name, labels[name]))
    return bytes(out)


def encode_write_raw_request(series: list[RawSeries],
                             normalized: bool = True) -> bytes:
    out = bytearray()
    for s in series:
        body = bytearray()
        put_tag_bytes(body, 1, _encode_labelset(s.labels))
        for sample in s.samples:
            sm = bytearray()
            put_tag_bytes(sm, 1, sample)
            put_tag_bytes(body, 2, bytes(sm))
        put_tag_bytes(out, 2, bytes(body))
    put_tag_varint(out, 3, 1 if normalized else 0)
    return bytes(out)


def decode_write_raw_request(data: bytes) -> tuple[list[RawSeries], bool]:
    """Inverse of encode (tests + the in-memory store fake)."""
    series: list[RawSeries] = []
    normalized = False
    for field, wt, value in iter_fields(data):
        if field == 2 and wt == 2:
            labels: dict[str, str] = {}
            samples: list[bytes] = []
            for f2, w2, v2 in iter_fields(value):
                if f2 == 1 and w2 == 2:  # LabelSet
                    for f3, w3, v3 in iter_fields(v2):
                        if f3 == 1 and w3 == 2:  # Label
                            name = val = ""
                            for f4, w4, v4 in iter_fields(v3):
                                if f4 == 1:
                                    name = v4.decode()
                                elif f4 == 2:
                                    val = v4.decode()
                            labels[name] = val
                elif f2 == 2 and w2 == 2:  # RawSample
                    for f3, w3, v3 in iter_fields(v2):
                        if f3 == 1 and w3 == 2:
                            samples.append(v3)
            series.append(RawSeries(labels, samples))
        elif field == 3 and wt == 0:
            normalized = bool(value)
    return series, normalized


def decode_varint_prefixed(data: bytes) -> tuple[int, int]:
    return get_varint(data, 0)
