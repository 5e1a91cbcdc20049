"""Self-profiling: the agent samples its own threads into pprof.

The port's copy of parca_agent_tpu's profiler/selfprofile.py, over this
package's pprof/builder.py.

Role of the reference's /debug/pprof/* endpoints and per-component
runtimepprof labels (cmd/parca-agent/main.go:269-275,256): operators
profile the profiler. Go gets this from its runtime; here the agent
runtime is Python threads over native/CUDA calls, so the self-profiler is
a sampling wall-clock profiler over `sys._current_frames()` — every
actor thread (profiler, batch, http, discovery-*, encode-pipeline) is
attributed by its thread name via a `thread` sample label, the analog of
the reference's `component` profile labels. The encode-pipeline worker
matters here: with pipelined encoding the per-window pprof serialization
cost moves OFF the profiler thread, and its self-profile attribution is
how an operator verifies the overlap is real (encode samples under
`thread=encode-pipeline`, capture samples under `thread=profiler`).

The output is standard gzipped profile.proto with function/line info, so
any pprof consumer (including this repo's parse_pprof) reads it. Building
it exercises the same wire codec the main profile path uses.
"""

from __future__ import annotations

import gzip
import sys
import threading
import time

from parca_agent_tpu_torch.pprof import proto
from parca_agent_tpu_torch.pprof.builder import (
    F_FILENAME,
    F_ID,
    F_NAME,
    F_SYSTEM_NAME,
    L_KEY,
    L_STR,
    LINE_FUNCTION_ID,
    LINE_LINE,
    LOC_ID,
    LOC_LINE,
    P_DURATION_NANOS,
    P_FUNCTION,
    P_LOCATION,
    P_PERIOD,
    P_PERIOD_TYPE,
    P_SAMPLE,
    P_SAMPLE_TYPE,
    P_STRING_TABLE,
    P_TIME_NANOS,
    S_LABEL,
    S_LOCATION_ID,
    S_VALUE,
    VT_TYPE,
    VT_UNIT,
    _Strings,
)

MAX_SELF_DEPTH = 127  # same stack budget as the capture path


def collect_samples(duration_s: float, hz: float = 100.0,
                    frames_fn=None, clock=time.monotonic,
                    sleep=time.sleep) -> dict:
    """Sample all threads' Python stacks for duration_s at hz.

    Returns {(thread_name, leaf-first ((file, func, line), ...)): count}.
    frames_fn/clock/sleep are injectable for tests.
    """
    frames_fn = frames_fn or sys._current_frames
    me = threading.get_ident()
    counts: dict = {}
    period = 1.0 / hz
    deadline = clock() + duration_s
    while clock() < deadline:
        names = {t.ident: t.name for t in threading.enumerate()}
        for ident, frame in frames_fn().items():
            if ident == me:
                continue  # don't profile the profiling thread
            stack = []
            f = frame
            while f is not None and len(stack) < MAX_SELF_DEPTH:
                code = f.f_code
                stack.append((code.co_filename, code.co_name, f.f_lineno))
                f = f.f_back
            if not stack:
                continue
            key = (names.get(ident, f"thread-{ident}"), tuple(stack))
            counts[key] = counts.get(key, 0) + 1
        sleep(period)
    return counts


class _ProfileEmitter:
    """Shared profile.proto emitter for the self-profile flavors: interns
    (file, func, line) stacks into location/function tables, then writes
    the string table + headers once. Both the wall-clock and heap builders
    go through here so a wire-format fix lands in exactly one place."""

    def __init__(self, sample_types: list[tuple[str, str]]):
        self.st = _Strings()
        self.w = proto.Writer()
        for typ, unit in sample_types:
            vt = proto.Writer().varint(VT_TYPE, self.st(typ)).varint(
                VT_UNIT, self.st(unit))
            self.w.message(P_SAMPLE_TYPE, vt.buf)
        self._func_ids: dict[tuple[str, str], int] = {}
        self._loc_ids: dict[tuple[int, int], int] = {}
        self._functions: list[tuple[str, str]] = []
        self._locations: list[tuple[int, int]] = []

    def _loc_for(self, file: str, func: str, line: int) -> int:
        fkey = (file, func)
        fid = self._func_ids.get(fkey)
        if fid is None:
            fid = self._func_ids[fkey] = len(self._functions) + 1
            self._functions.append(fkey)
        lkey = (fid, line)
        lid = self._loc_ids.get(lkey)
        if lid is None:
            lid = self._loc_ids[lkey] = len(self._locations) + 1
            self._locations.append(lkey)
        return lid

    def add_sample(self, stack, values: list[int],
                   labels: dict[str, str] | None = None) -> None:
        """stack: leaf-first ((file, func, line), ...)."""
        sw = proto.Writer()
        sw.packed(S_LOCATION_ID,
                  [self._loc_for(f, fn, ln) for f, fn, ln in stack])
        sw.packed(S_VALUE, values)
        for k, v in (labels or {}).items():
            lw = proto.Writer().varint(L_KEY, self.st(k)).varint(
                L_STR, self.st(v))
            proto.put_tag_bytes(sw.buf, S_LABEL, bytes(lw.buf))
        self.w.message(P_SAMPLE, sw.buf)

    def finish(self, time_ns: int | None = None, duration_ns: int = 0,
               period_type: tuple[str, str] | None = None,
               period: int = 0, compress: bool = True) -> bytes:
        for lid, (fid, line) in enumerate(self._locations, 1):
            lw = proto.Writer().varint(LOC_ID, lid)
            lnw = proto.Writer().varint(LINE_FUNCTION_ID, fid).varint(
                LINE_LINE, line)
            lw.message(LOC_LINE, lnw.buf)
            self.w.message(P_LOCATION, lw.buf)
        for fid, (file, func) in enumerate(self._functions, 1):
            fw = (proto.Writer()
                  .varint(F_ID, fid)
                  .varint(F_NAME, self.st(func))
                  .varint(F_SYSTEM_NAME, self.st(func))
                  .varint(F_FILENAME, self.st(file)))
            self.w.message(P_FUNCTION, fw.buf)
        pt = None
        if period_type is not None:
            pt = proto.Writer().varint(VT_TYPE, self.st(period_type[0])) \
                .varint(VT_UNIT, self.st(period_type[1]))
        for s in self.st.table:
            proto.put_tag_bytes(self.w.buf, P_STRING_TABLE, s.encode())
        self.w.varint(P_TIME_NANOS,
                      time_ns if time_ns is not None else time.time_ns())
        if duration_ns:
            self.w.varint(P_DURATION_NANOS, duration_ns)
        if pt is not None:
            self.w.message(P_PERIOD_TYPE, pt.buf)
        if period:
            self.w.varint(P_PERIOD, period)
        data = self.w.getvalue()
        return gzip.compress(data, 6) if compress else data


def build_self_pprof(counts: dict, duration_s: float, hz: float = 100.0,
                     time_ns: int | None = None,
                     compress: bool = True) -> bytes:
    """Encode collected samples as profile.proto: samples/count +
    cpu/nanoseconds values, leaf-first locations with function+line."""
    period_ns = int(1e9 / hz)
    em = _ProfileEmitter([("samples", "count"), ("cpu", "nanoseconds")])
    for (thread_name, stack), n in sorted(
            counts.items(), key=lambda kv: -kv[1]):
        em.add_sample(stack, [n, n * period_ns], {"thread": thread_name})
    return em.finish(time_ns=time_ns, duration_ns=int(duration_s * 1e9),
                     period_type=("cpu", "nanoseconds"), period=period_ns,
                     compress=compress)


def profile_self(duration_s: float = 10.0, hz: float = 100.0) -> bytes:
    """One-call self profile: sample then encode (the /debug/pprof/profile
    handler body)."""
    t0 = time.time_ns()
    counts = collect_samples(duration_s, hz)
    return build_self_pprof(counts, duration_s, hz, time_ns=t0)


def heap_self(seconds: float = 5.0, top: int = 512,
              sleep=time.sleep) -> bytes:
    """Heap profile via a BOUNDED tracemalloc window (the
    /debug/pprof/heap role): start tracing, wait `seconds`, snapshot the
    allocations still live from that window, then STOP tracing so the
    agent pays the 2-4x allocation overhead only for the window — not
    for the rest of its life. If something else already enabled
    tracemalloc, the snapshot is immediate and tracing is left running
    (it isn't ours to stop)."""
    import tracemalloc

    started_here = not tracemalloc.is_tracing()
    if started_here:
        tracemalloc.start(8)
        sleep(seconds)
    try:
        snapshot = tracemalloc.take_snapshot()
    finally:
        if started_here:
            tracemalloc.stop()
    stats = snapshot.statistics("traceback")[:top]
    counts: dict = {}
    sizes: dict = {}
    for st in stats:
        stack = tuple((fr.filename, "", fr.lineno)
                      for fr in reversed(st.traceback))[:MAX_SELF_DEPTH]
        if not stack:
            continue
        counts[stack] = counts.get(stack, 0) + st.count
        sizes[stack] = sizes.get(stack, 0) + st.size
    em = _ProfileEmitter([("inuse_objects", "count"),
                          ("inuse_space", "bytes")])
    for stack, n in sorted(counts.items(), key=lambda kv: -sizes[kv[0]]):
        em.add_sample(
            tuple((f, fn or f.rsplit("/", 1)[-1], ln)
                  for f, fn, ln in stack),
            [n, sizes[stack]])
    return em.finish(duration_ns=int(seconds * 1e9))
