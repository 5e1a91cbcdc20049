"""The plain reference against a window worked out by hand, and the
frozen pprof decoder against a profile written by hand."""

import gzip

import numpy as np

from benchmark import manifest, pprof_decode
from benchmark.replay import Mapping

exact = manifest.reference("exact")

EXE = Mapping(0x5500_0000_0000, 0x5500_0100_0000, 0, "/app/bin/worker")
LIB = Mapping(0x7F00_0000_0000, 0x7F00_0100_0000, 0x1000, "/usr/lib/a.so")
K = 0xFFFF_8000_0000_1040
IDS = {"/app/bin/worker": "aa", "/usr/lib/a.so": "bb"}


def _drain(rows):
    """rows: [(pid, [frames], user_len, count)] -> drain columns."""
    n = len(rows)
    stacks = np.zeros((n, 128), np.uint64)
    for i, (_, frames, _, _) in enumerate(rows):
        stacks[i, :len(frames)] = frames
    pids = np.array([r[0] for r in rows], np.int32)
    ulen = np.array([r[2] for r in rows], np.int32)
    klen = np.array([len(r[1]) - r[2] for r in rows], np.int32)
    counts = np.array([r[3] for r in rows], np.int64)
    return (pids, pids.copy(), ulen, klen, stacks, counts)


S1 = [EXE.start + 0x140, LIB.start + 0x240, K]   # two user frames, kernel
S2 = [LIB.start + 0x40, EXE.start + 0x40]


def test_reference_by_hand():
    drains = [_drain([(7, S1, 2, 3), (7, S2, 2, 1), (9, S2, 2, 5)]),
              _drain([(7, S1, 2, 4), (9, S1, 2, 2)])]
    total, pids = exact.window_summary(drains)
    assert total == 15 and pids.tolist() == [7, 9]
    want = exact.expected_profiles(drains, [7], lambda p: [EXE, LIB], IDS)
    s1 = ((EXE.start, 0x140), (LIB.start, 0x240 + 0x1000), (0, K))
    s2 = ((LIB.start, 0x40 + 0x1000), (EXE.start, 0x40))
    assert want[7]["stacks"] == {s1: 7, s2: 1}
    assert want[7]["mass"] == 8
    assert want[7]["mappings"] == {
        EXE.start: (EXE.start, EXE.end, 0, EXE.path, "aa"),
        LIB.start: (LIB.start, LIB.end, 0x1000, LIB.path, "bb")}


def _varint(v):
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def _field(num, value):
    if isinstance(value, int):
        return _varint(num << 3) + _varint(value)
    return _varint(num << 3 | 2) + _varint(len(value)) + value


def _msg(*pairs):
    return b"".join(_field(n, v) for n, v in pairs)


def _packed(values):
    return b"".join(_varint(v) for v in values)


def _profile():
    strings = ["", "samples", "count", "/app/bin/worker", "aa"]
    body = _msg(
        (2, _msg((1, _packed([1, 2])), (2, _packed([6])))),
        (2, _msg((1, _packed([2])), (2, _packed([0])))),   # a dead row
        (2, _msg((1, _packed([2, 1])), (2, _packed([2])))),
        (3, _msg((1, 1), (2, EXE.start), (3, EXE.end), (4, 0), (5, 3),
                 (6, 4))),
        (4, _msg((1, 1), (2, 1), (3, 0x140))),
        (4, _msg((1, 2), (2, 0), (3, K))))
    body += b"".join(_field(6, s.encode()) for s in strings)
    return body + _field(12, 10_000_000)


def test_decoder_by_hand():
    for blob in (_profile(), gzip.compress(_profile())):
        prof = pprof_decode.decode(blob)
        assert prof["period"] == 10_000_000
        got, used = pprof_decode.stacks(prof)
        assert got == {((EXE.start, 0x140), (0, K)): 6,
                       ((0, K), (EXE.start, 0x140)): 2}
        assert used == {EXE.start: (EXE.start, EXE.end, 0,
                                    "/app/bin/worker", "aa")}
