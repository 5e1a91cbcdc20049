"""The port's self-profiler (profiler/selfprofile.py) held to
parca_agent_tpu's.

The cases of tests/test_selfprofile.py: `collect_samples` over the same
injected frames, clock and sleep gives the same counts in both packages;
`build_self_pprof` and the shared emitter give the same profile.proto
bytes for the same counts (exact, uncompressed; the gzip member equal
with its mtime field zeroed); the live sampler sees other threads and
not itself; the heap profile's bounded tracemalloc window; and the
`/debug/pprof/*` endpoints of the port's HTTP server.
"""

from __future__ import annotations

import gzip
import threading
import urllib.error
import urllib.request

import pytest
import torch

from parca_agent_tpu.profiler import selfprofile as jax_sp
from parca_agent_tpu_torch.pprof.builder import parse_pprof
from parca_agent_tpu_torch.profiler import selfprofile as port_sp
from parca_agent_tpu_torch.web import AgentHTTPServer

torch.set_num_threads(1)


def _busy(stop):
    while not stop.is_set():
        sum(i * i for i in range(500))


def _unstamped(gz: bytes) -> bytes:
    """A gzip member with its mtime field (header bytes 4-8) zeroed."""
    return gz[:4] + b"\0\0\0\0" + gz[8:]


COUNTS = {
    "two threads": {
        ("worker", (("/a.py", "leaf", 3), ("/a.py", "caller", 9))): 7,
        ("batch", (("/b.py", "send", 12),)): 2,
    },
    "shared frames": {
        ("t1", (("/x.py", "f", 1), ("/y.py", "g", 2))): 3,
        ("t2", (("/x.py", "f", 1), ("/y.py", "g", 2))): 3,
        ("t1", (("/x.py", "f", 5),)): 1,
    },
    "empty": {},
    "deep": {("actor-profiler", tuple(("/m.py", f"fn{i}", i)
                                      for i in range(127))): 11},
}


@pytest.mark.parametrize("case", sorted(COUNTS))
@pytest.mark.parametrize("hz", [100.0, 19.0])
def test_build_self_pprof_bytes_equal(case, hz):
    counts = COUNTS[case]
    kw = dict(duration_s=1.5, hz=hz, time_ns=123_456)
    raw = port_sp.build_self_pprof(counts, compress=False, **kw)
    assert raw == jax_sp.build_self_pprof(counts, compress=False, **kw)
    assert _unstamped(port_sp.build_self_pprof(counts, **kw)) == \
        _unstamped(jax_sp.build_self_pprof(counts, **kw))
    assert gzip.decompress(port_sp.build_self_pprof(counts, **kw)) == raw


def test_build_self_pprof_roundtrip():
    prof = parse_pprof(port_sp.build_self_pprof(
        COUNTS["two threads"], duration_s=1.0, hz=100, time_ns=123))
    assert prof.sample_types == [("samples", "count"), ("cpu", "nanoseconds")]
    assert prof.period == 10_000_000
    assert prof.duration_nanos == 1_000_000_000 and prof.time_nanos == 123
    by_thread = {lbl["thread"]: (locs, vals)
                 for locs, vals, lbl in prof.samples}
    locs, vals = by_thread["worker"]
    assert vals == (7, 7 * 10_000_000)
    names = []
    for lid in locs:
        (fid, line), = prof.locations[lid]["lines"]
        names.append((prof.functions[fid]["name"], line))
    assert names == [("leaf", 3), ("caller", 9)]


@pytest.mark.parametrize("types", [
    [("inuse_objects", "count"), ("inuse_space", "bytes")],
    [("samples", "count")]])
def test_profile_emitter_bytes_equal(types):
    """The emitter both flavors share (the heap profile's path), fed the
    same stacks and values."""
    def emit(mod):
        em = mod._ProfileEmitter(types)
        em.add_sample((("/h.py", "", 3), ("/h.py", "alloc", 9)),
                      [4, 4096][:len(types)])
        em.add_sample((("/g.py", "g", 1),), [1, 64][:len(types)],
                      {"k": "v"})
        return em.finish(time_ns=5, duration_ns=7, compress=False)

    assert emit(port_sp) == emit(jax_sp)


class _Code:
    def __init__(self, file, name):
        self.co_filename, self.co_name = file, name


class _Frame:
    def __init__(self, file, name, line, back=None):
        self.f_code, self.f_lineno, self.f_back = _Code(file, name), line, back


def _chain(*frames):
    back = None
    for file, name, line in reversed(frames):
        back = _Frame(file, name, line, back)
    return back


def test_collect_samples_equal_on_injected_frames():
    """Both samplers over the same frames, clock and sleep: 5 ticks of
    two threads (one of them unnamed) and this thread, which is left
    out."""
    me = threading.get_ident()
    named = threading.current_thread()

    def run(mod):
        t = [0.0]
        frames = {me: _chain(("/self.py", "collect", 1)),
                  -1: _chain(("/a.py", "leaf", 3), ("/a.py", "main", 1)),
                  -2: _chain(("/b.py", "x", 7))}

        def sleep(s):
            t[0] += s

        return mod.collect_samples(0.05, hz=100, frames_fn=lambda: frames,
                                   clock=lambda: t[0], sleep=sleep)

    got = run(port_sp)
    assert got == run(jax_sp)
    assert sum(got.values()) == 10 and named.name not in \
        {name for name, _ in got}


def test_collect_samples_sees_other_threads():
    stop = threading.Event()
    t = threading.Thread(target=_busy, args=(stop,), name="busy-worker")
    t.start()
    try:
        counts = port_sp.collect_samples(0.25, hz=200)
    finally:
        stop.set()
        t.join()
    busy = [s for (th, s) in counts if th == "busy-worker"]
    assert any(any(fn == "_busy" for _, fn, _ in stack) for stack in busy)
    outermost = busy[0][-1]
    assert "threading" in outermost[0] or "_bootstrap" in outermost[1]


def test_collect_samples_excludes_self():
    for (_, stack) in port_sp.collect_samples(0.05, hz=100):
        assert not any(fn == "collect_samples" for _, fn, _ in stack)


def test_profile_self_end_to_end():
    stop = threading.Event()
    t = threading.Thread(target=_busy, args=(stop,), name="busy-e2e")
    t.start()
    try:
        data = port_sp.profile_self(duration_s=0.2, hz=200)
    finally:
        stop.set()
        t.join()
    prof = parse_pprof(data)
    assert "busy-e2e" in {lbl["thread"] for _, _, lbl in prof.samples}


def test_heap_self_profile_bounded_window():
    import tracemalloc

    blob = []

    def alloc_during_window(_s):
        blob.extend(bytearray(4096) for _ in range(100))

    assert not tracemalloc.is_tracing()
    prof = parse_pprof(port_sp.heap_self(seconds=0.1,
                                         sleep=alloc_during_window))
    assert not tracemalloc.is_tracing()
    assert prof.sample_types == [("inuse_objects", "count"),
                                 ("inuse_space", "bytes")]
    assert sum(v[1] for _, v, _ in prof.samples) >= 100 * 4096
    del blob


def test_heap_self_respects_external_tracing():
    import tracemalloc

    tracemalloc.start()
    try:
        junk = [dict(x=i) for i in range(2000)]  # noqa: F841
        prof = parse_pprof(port_sp.heap_self(seconds=30))  # no sleep
        assert prof.samples and tracemalloc.is_tracing()
    finally:
        tracemalloc.stop()


@pytest.fixture
def server():
    srv = AgentHTTPServer("127.0.0.1", 0)
    srv.start()
    yield f"http://127.0.0.1:{srv.port}"
    srv.stop()


def test_debug_pprof_profile_endpoint(server):
    stop = threading.Event()
    t = threading.Thread(target=_busy, args=(stop,), name="busy-http")
    t.start()
    try:
        with urllib.request.urlopen(
                f"{server}/debug/pprof/profile?seconds=0.2", timeout=10) as r:
            assert r.headers["Content-Disposition"] == \
                'attachment; filename="profile.pb.gz"'
            prof = parse_pprof(r.read())
    finally:
        stop.set()
        t.join()
    assert any(lbl.get("thread") == "busy-http"
               for _, _, lbl in prof.samples)
    with urllib.request.urlopen(f"{server}/debug/pprof/", timeout=5) as r:
        assert b"profile" in r.read()
    with urllib.request.urlopen(f"{server}/debug/pprof/cmdline",
                                timeout=5) as r:
        assert r.read()


def test_debug_pprof_heap_endpoint(server):
    with urllib.request.urlopen(f"{server}/debug/pprof/heap?seconds=0.2",
                                timeout=10) as r:
        assert parse_pprof(r.read()).sample_types[0] == \
            ("inuse_objects", "count")


@pytest.mark.parametrize("path", [
    "profile?seconds=abc", "profile?seconds=0", "profile?seconds=301",
    "heap?seconds=0", "heap?seconds=-1"])
def test_debug_pprof_rejects_bad_seconds(server, path):
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(f"{server}/debug/pprof/{path}", timeout=5)
    assert ei.value.code == 400


def test_debug_pprof_unknown_profile_is_404(server):
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(f"{server}/debug/pprof/goroutine", timeout=5)
    assert ei.value.code == 404
