"""Thread-safety stress tests of the port's shared components: the cases
of tests/test_thread_safety.py on parca_agent_tpu_torch.

Each component is shared across the agent's actor threads: the labels
manager (window writes from the loop and the encode worker, the config
reloader), the batch client (writes against its flush loop), the unwind
table cache (drain threads against its builder), the profile listener
(/query waiters against writers) and the dictionary on the CPU (feeds
and closes against the /metrics readers). Each test hammers the real
cross-thread call pattern under a shortened switch interval and asserts
an end-state invariant that a lost update, a double delete or a read
mid-mutation would break. The work is deterministic in total; only the
interleaving varies.
"""

import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

N_THREADS = 8
BARRIER_TIMEOUT = 30


@pytest.fixture(autouse=True)
def _fast_switching():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        yield
    finally:
        sys.setswitchinterval(old)


def _hammer(n_threads, fn):
    """Run fn(thread_idx) concurrently; re-raise the first exception."""
    barrier = threading.Barrier(n_threads, timeout=BARRIER_TIMEOUT)
    errors = []

    def wrap(i):
        try:
            barrier.wait()
            fn(i)
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=wrap, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads), "stress thread hung"
    if errors:
        raise errors[0]


def test_labels_manager_concurrent_label_set_and_reconfig():
    """label_set from many threads racing cache expiry, purge sweeps and
    apply_config swaps: the TTL caches never KeyError on a key deleted
    twice."""
    from parca_agent_tpu_torch.labels.manager import LabelsManager
    from parca_agent_tpu_torch.labels.relabel import RelabelConfig

    t = [0.0]
    mgr = LabelsManager([], relabel_configs=[],
                        profiling_duration_s=0.001, clock=lambda: t[0])

    def work(i):
        for k in range(3000):
            t[0] += 0.0005
            labels = mgr.label_set("cpu", (i * 7 + k) % 41)
            assert labels["__name__"] == "cpu"
            if i == 0 and k % 500 == 0:
                mgr.apply_config([RelabelConfig(
                    action="replace", source_labels=["pid"],
                    target_label="slot", replacement="x")])

    _hammer(N_THREADS, work)


def test_batch_write_client_no_sample_loss_under_flaky_store():
    """write_raw from N threads racing the flush loop against a store that
    fails every other batch: every sample is sent exactly once or still
    buffered."""
    from parca_agent_tpu_torch.agent.batch import BatchWriteClient

    sent = []
    fail = [True]
    lock = threading.Lock()

    class FlakyStore:
        def write_raw(self, series, normalized):
            with lock:
                fail[0] = not fail[0]
                if fail[0]:
                    raise ConnectionError("transient")
                for s in series:
                    sent.extend(s.samples)

    client = BatchWriteClient(FlakyStore(), interval_s=0.005,
                              initial_backoff_s=0.001)
    runner = threading.Thread(target=client.run, daemon=True)
    runner.start()
    per_thread = 400

    def work(i):
        for k in range(per_thread):
            client.write_raw({"pid": str(k % 17), "t": str(i)},
                             f"{i}:{k}".encode())

    try:
        _hammer(N_THREADS, work)
    finally:
        client.stop()
        runner.join(timeout=10)
    assert not runner.is_alive()
    leftover = [smp for s in client._swap() for smp in s.samples]
    total = len(sent) + len(leftover)
    assert total == N_THREADS * per_thread
    assert len(set(sent + leftover)) == total


def test_unwind_table_cache_concurrent_lookup_and_build():
    """table_for from N drain threads while the builder churns and
    build_now races it; corrupt objects must not wedge the builder."""
    from parca_agent_tpu_torch.capture.live import UnwindTableCache
    from parca_agent_tpu_torch.process.maps import ProcMapping
    from parca_agent_tpu_torch.utils.vfs import FakeFS

    with open("tests/fixtures/fixture_pie", "rb") as f:
        elf = f.read()
    files = {}
    for pid in range(24):
        files[f"/proc/{pid}/comm"] = b"stress\n"
        files[f"/proc/{pid}/root/bin/app"] = \
            elf if pid % 2 == 0 else b"\x7fELFgarbage"

    class Maps:
        def executable_mappings(self, pid):
            return [ProcMapping(0x1000, 0x5000, "r-xp", 0x1000, "08:01", 7,
                                "/bin/app")]

    cache = UnwindTableCache(Maps(), comm_regex="stress", refresh_s=0.01,
                             fs=FakeFS(files))

    def work(i):
        for k in range(300):
            pid = (i + k) % 24
            assert cache.matches(pid)
            t = cache.table_for(pid)
            if t is not None and len(t):
                assert t.lookup([0x1000])[0] >= -1
            if k % 97 == 0:
                cache.build_now(pid)

    try:
        _hammer(N_THREADS, work)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            with cache._lock:
                built = len(cache._built_at)
            if built == 24 and not cache._queue:
                break
            time.sleep(0.02)
        assert built == 24
        assert cache.stats["builds"] >= 12
        for pid in range(0, 24, 2):
            t = cache.table_for(pid)
            assert t is not None and len(t) > 0
    finally:
        cache.close()


def test_matching_profile_listener_waiters_vs_writers():
    """/query waiters registering and timing out while profiles are
    written each see exactly one matching profile."""
    from parca_agent_tpu_torch.agent.listener import MatchingProfileListener

    class Sink:
        def write_raw(self, labels, sample):
            pass

    listener = MatchingProfileListener(next_writer=Sink())
    got = []
    glock = threading.Lock()
    waiters_done = threading.Event()
    done = [0]

    def work(i):
        if i % 2 == 0:
            k = 0
            while not waiters_done.is_set():
                listener.write_raw({"pid": str(k % 5)}, b"x")
                k += 1
        else:
            try:
                for _ in range(40):
                    r = listener.next_matching_profile(
                        lambda lb: lb.get("pid") == "3", timeout=5.0)
                    with glock:
                        got.append(r)
            finally:
                with glock:
                    done[0] += 1
                    if done[0] == N_THREADS // 2:
                        waiters_done.set()

    _hammer(N_THREADS, work)
    assert len(got) == 40 * (N_THREADS // 2)
    assert all(r is not None and r[0]["pid"] == "3" for r in got)


def test_dict_aggregator_feed_close_vs_readers():
    """The loop feeds and closes while /metrics threads read stats and
    timings and query the sketch: every close's total stays exact."""
    from parca_agent_tpu_torch.aggregator.dict import DictAggregator
    from parca_agent_tpu_torch.capture.synthetic import SyntheticSpec, generate

    snap = generate(SyntheticSpec(n_pids=50, n_unique_stacks=4096,
                                  n_rows=4096, total_samples=100_000,
                                  seed=3))
    agg = DictAggregator(capacity=1 << 15, id_cap=1 << 14, device="cpu")
    hashes = agg.hash_rows(snap)
    total = int(snap.counts.sum())
    stop = threading.Event()

    def reader():
        while not stop.is_set():
            dict(agg.stats)
            dict(agg.timings)
            agg.sketch_estimate(hashes[0][:16])

    readers = [threading.Thread(target=reader, daemon=True)
               for _ in range(3)]
    for r in readers:
        r.start()
    try:
        for _ in range(4):
            for lo in range(0, 4096, 1024):
                agg.feed(snap, hashes, lo, lo + 1024)
            counts = agg.close_window()
            assert int(counts.sum()) == total
    finally:
        stop.set()
        for r in readers:
            r.join(timeout=5)
    assert not any(r.is_alive() for r in readers)


def test_metrics_render_vs_the_loop(tmp_path):
    """/metrics renders from HTTP threads while the loop runs windows and
    writes profiles on its own: every render parses, and the counters
    never go back."""
    from parca_agent_tpu_torch.aggregator.dict import DictAggregator
    from parca_agent_tpu_torch.capture.synthetic import SyntheticSpec, generate
    from parca_agent_tpu_torch.profiler.cpu import CPUProfiler
    from parca_agent_tpu_torch.web import render_metrics
    from test_metrics_format import parse_prometheus_text

    snaps = [generate(SyntheticSpec(n_pids=20, n_unique_stacks=512,
                                    n_rows=512, total_samples=10_000,
                                    seed=s)) for s in range(1, 7)]

    class Source:
        def poll(self):
            return snaps.pop() if snaps else None

    class Sink:
        def write(self, labels, blob):
            pass

    loop = CPUProfiler(Source(), DictAggregator(capacity=1 << 13,
                                                device="cpu"),
                       profile_writer=Sink(), duration_s=0.0)
    stop = threading.Event()
    seen = []

    def scrape(i):
        last = 0
        while not stop.is_set():
            fams = parse_prometheus_text(render_metrics([loop]))
            n = fams["parca_agent_profiler_profiles_written_total"][
                "samples"][0][2]
            assert n >= last
            last = n
        seen.append(last)

    scrapers = [threading.Thread(target=scrape, args=(i,))
                for i in range(3)]
    for t in scrapers:
        t.start()
    try:
        loop.run()
    finally:
        stop.set()
        for t in scrapers:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in scrapers)
    assert loop.metrics.attempts_total == 6 and len(seen) == 3
    assert loop.metrics.profiles_written == 6 * 20


def test_hotspot_fold_vs_queries():
    """One thread folds windows into a HotspotStore (the encode worker)
    while others query it and scrape its metrics (HTTP threads): every
    answer is well-formed and bounded by what was folded, and once the
    folds end the store answers as one that folded them with no readers
    did."""
    import numpy as np

    from parca_agent_tpu_torch.ops.sketch import CountMinSpec
    from parca_agent_tpu_torch.runtime.hotspots import (
        HotspotSpec,
        HotspotStore,
        WindowSummary,
    )

    spec = HotspotSpec(k=10, candidates=64, cm=CountMinSpec(depth=3,
                                                              width=256))
    rng = np.random.default_rng(0)
    sums = []
    for w in range(60):
        n = 500
        h1 = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
        h2 = rng.integers(0, 64, n).astype(np.uint32)
        counts = rng.integers(1, 100, n).astype(np.int64)
        sums.append(WindowSummary.build(
            h1, h2, counts,
            lambda i: (i % 7, (f"f{i}",), {"pid": str(i % 7)}),
            spec, w * 10**10, 10**10))
    total = sum(s.total for s in sums)

    def store():
        return HotspotStore(spec=spec, rollup_spans_s=(30.0, 60.0),
                            level_bytes=1 << 16, clock=lambda: 0.0)

    shared, alone = store(), store()
    done = threading.Event()
    errors = []

    def fold():
        for s in sums:
            shared.fold(s)
        done.set()

    def read(i):
        while not done.is_set():
            ans = shared.query(k=10, selector={"pid": str(i % 7)}
                               if i % 2 else None)
            assert 0 <= ans["total_samples"] <= total
            assert len(ans["entries"]) <= 10
            assert all(e["count"] <= e["estimate"]
                       for e in ans["entries"])
            shared.metrics()
            shared.snapshot()

    def worker(i):
        try:
            fold() if i == 0 else read(i)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)
            done.set()

    _hammer(N_THREADS, worker)
    assert not errors, errors[0]
    for s in sums:
        alone.fold(s)

    def answer(st):
        out = st.query(k=10, t0_s=0.0, t1_s=1e4)
        out.pop("query_s")
        return out

    assert answer(shared) == answer(alone)
    assert shared.stats["windows_folded"] == len(sums)
