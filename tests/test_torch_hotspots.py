"""The port's hotspot rollups (runtime/hotspots.py) held to
parca_agent_tpu's.

Every case of tests/test_hotspots.py and tests/test_hotspots_chaos.py
runs here through the port (tests/torch_port_cases.py), with the
original's assertions. Below them, the same seeded inputs go through both
packages and the outputs are compared exactly: the summaries' tables and
cut, the store's query answers at every level and scope, the /hotspots
JSON bodies, the metrics, and the chaos sites' counters.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_port_cases import (  # noqa: E402
    FakeClock,
    pkg,
    plain,
    port_cases,
    port_on_cpu,  # noqa: F401 - autouse fixture
)

port_cases("test_hotspots", globals())
port_cases("test_hotspots_chaos", globals())


# -- the two packages on the same inputs ----------------------------------------

BOTH = ("jax", "port")
SEC = 1_000_000_000
TIMINGS = ("query_s", "last_fold_s")


def _spec(which, k=8, candidates=24, width=1 << 8, frames=4):
    hot = pkg(which, "runtime.hotspots")
    cm = pkg(which, "ops.sketch").CountMinSpec(depth=3, width=width)
    return hot.HotspotSpec(k=k, candidates=candidates, cm=cm, frames=frames)


def _stream(seed, n, collide=False):
    rng = np.random.default_rng(seed)
    h1 = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    h2 = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    if collide:
        # Repeated 64-bit keys inside one stream merge in the summary.
        h1[n // 2:], h2[n // 2:] = h1[: n - n // 2], h2[: n - n // 2]
    counts = np.minimum(rng.zipf(1.3, n), 1 << 20).astype(np.int64)
    return h1, h2, counts


def _ctx(i):
    return 100 + i % 5, (f"bin{i % 3}+0x{i:x}",), {"pid": str(100 + i % 5)}


@pytest.mark.parametrize("n,collide", [(16, False), (200, False),
                                       (200, True), (3000, False)])
def test_parity_summaries_build_merge_and_size(n, collide):
    """WindowSummary.build, merge_in and nbytes: the tables, the cut,
    the count-min table, the totals, equal in both packages."""
    out = {}
    for which in BOTH:
        hot = pkg(which, "runtime.hotspots")
        spec = _spec(which)
        sums = [hot.WindowSummary.build(*_stream(seed, n, collide), _ctx,
                                        spec, seed * 10 * SEC, 10 * SEC)
                for seed in range(4)]
        built = [plain(s) for s in sums]
        acc = hot.WindowSummary(spec)
        merged = []
        for s in sums:
            acc.merge_in(s, spec)
            merged.append((plain(acc), acc.nbytes()))
        out[which] = built, merged, [s.nbytes() for s in sums]
    assert out["jax"] == out["port"]
    # Past the candidate bound a summary prunes, and its cut shows it.
    built, merged, _ = out["port"]
    assert all((b[1]["cut"] > 0) == (n > 24) for b in built)
    assert merged[-1][0][1]["cut"] > 0


def _window(which, seed, pids=6, rows=256):
    syn = pkg(which, "capture.synthetic")
    return syn.generate(syn.SyntheticSpec(
        n_pids=pids, n_unique_stacks=rows, n_rows=rows,
        total_samples=rows * 8, mean_depth=6, kernel_fraction=0.2,
        seed=seed))


def _stores(windows=6, invalidate_at=3, labels=True):
    """Both packages' dictionaries aggregate the same windows; each
    window folds into a HotspotStore through a RegistryView taken at
    hand-off, as the CLI's pipeline does; window `invalidate_at` is
    preceded by a pid invalidation (a compaction that remaps ids)."""
    out = {}
    for which in BOTH:
        hot = pkg(which, "runtime.hotspots")
        kw = {} if which == "jax" else {"device": "cpu"}
        agg = pkg(which, "aggregator.dict").DictAggregator(
            capacity=1 << 12, **kw)
        clock = FakeClock()
        store = hot.HotspotStore(
            spec=_spec(which), window_s=10.0, rollup_spans_s=(30.0, 60.0),
            level_bytes=1 << 16, clock=clock,
            labels_for=((lambda pid: {"pid": str(pid),
                                      "tenant": f"t{pid % 2}"})
                        if labels else None))
        for w in range(windows):
            snap = _window(which, w + 1)
            if w == invalidate_at:
                assert agg.invalidate_pid(int(snap.pids[0]))
            counts = np.asarray(agg.window_counts(snap))
            idx = np.flatnonzero(counts)
            view = hot.RegistryView(agg)
            store.fold_from_aggregator(view, idx, counts[idx],
                                       (w + 1) * 10 * SEC, 10 * SEC)
            clock.t += 10.0
        out[which] = store, agg, clock
    return out


QUERIES = [
    {},
    {"k": 3},
    {"k": 100},
    {"selector": {"tenant": "t1"}},
    {"selector": {"pid": "1001"}},
    {"t0_s": 15.0, "t1_s": 35.0},
    {"t0_s": 0.0, "t1_s": 1000.0, "k": 5},
    {"scope": "fleet"},
]


def test_parity_store_fold_query_metrics_and_snapshot():
    """fold_from_aggregator over six windows (an invalidation's
    compaction among them), then every query form, metrics() and
    snapshot(): equal in both packages."""
    stores = _stores()
    got = {}
    for which, (store, agg, _) in stores.items():
        assert agg.registry_epoch == 1
        got[which] = ([plain(store.query(**q), TIMINGS) for q in QUERIES],
                      plain(store.metrics(), TIMINGS),
                      plain(store.snapshot(), TIMINGS))
    assert got["jax"] == got["port"]
    top = stores["port"][0].query(k=50)
    assert top["entries"] and all(e["frames"] for e in top["entries"])


def test_parity_frames_after_a_compaction_match_a_fresh_render():
    """The frames cache drops when a compaction bumps registry_epoch:
    the answers after it render the dictionary's current registry, as a
    store that never cached anything does."""
    for which in BOTH:
        store, agg, _ = _stores(windows=5, invalidate_at=4,
                                labels=False)[which]
        hot = pkg(which, "runtime.hotspots")
        ans = store.query(k=100, t0_s=51.0, t1_s=59.0)
        view = hot.RegistryView(agg)
        counts = np.asarray(agg.window_counts(_window(which, 5)))
        by_stack = {}
        h1, h2 = view.id_hashes()
        for sid in np.flatnonzero(counts).tolist():
            key = (int(h1[sid]) << 32) | int(h2[sid])
            by_stack[f"0x{key:016x}"] = list(
                hot.render_frames(view, sid, store.spec.frames))
        assert ans["entries"]
        for e in ans["entries"]:
            assert e["frames"] == by_stack[e["stack"]], which


def test_parity_fleet_fold_and_degrade():
    """fleet_fold of one merged stream, fleet-scope queries, then a
    degraded round and the clock past stale_after: equal answers."""
    stores = _stores(windows=2)
    h1, h2, counts = _stream(7, 300)
    got = {}
    for which, (store, agg, clock) in stores.items():
        view = pkg(which, "runtime.hotspots").RegistryView(agg)
        lh1, lh2 = view.id_hashes()
        # Half the round's rows are stacks this node knows.
        f1 = np.concatenate([lh1[:40], h1]).astype(np.uint32)
        f2 = np.concatenate([lh2[:40], h2]).astype(np.uint32)
        fc = np.concatenate([np.arange(40, 80), counts]).astype(np.int64)
        store.fleet_fold(f1, f2, fc, time_ns=30 * SEC)
        a = plain(store.query(k=20, scope="fleet"), TIMINGS)
        store.fleet_degraded("collective timed out")
        clock.t += 120.0
        b = plain(store.query(k=20, scope="fleet"), TIMINGS)
        got[which] = a, b, plain(store.metrics(), TIMINGS), \
            plain(store.snapshot(), TIMINGS)
    assert got["jax"] == got["port"]


def _http_get(base, path):
    try:
        with urllib.request.urlopen(base + path, timeout=10) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


HOTSPOT_PATHS = [
    "/hotspots", "/hotspots?k=3", "/hotspots?tenant=t1",
    "/hotspots?pid=1001&k=4", "/hotspots?t0=15&t1=35",
    "/hotspots?scope=fleet", "/hotspots?k=0", "/hotspots?scope=moon",
    "/hotspots?t0=inf", "/hotspots?tenant=%20bad", "/hotspots?range=-1",
]


def test_parity_hotspots_endpoint_bodies():
    """/hotspots in both packages' servers over equal stores: the same
    status and the same JSON body for each query, 400s included."""
    got = {}
    for which, (store, _, _) in _stores().items():
        srv = pkg(which, "web").AgentHTTPServer(port=0, profilers=[],
                                                hotspots=store)
        srv.start()
        try:
            base = f"http://127.0.0.1:{srv.port}"
            got[which] = [
                (code, plain(body, TIMINGS) if isinstance(body, dict)
                 else body)
                for code, body in (_http_get(base, p)
                                   for p in HOTSPOT_PATHS)]
            got[which].append(plain(_http_get(base, "/healthz")[1]))
        finally:
            srv.stop()
    assert [c for c, _ in got["port"][:-1]] == \
        [200] * 6 + [400] * 5
    assert got["jax"] == got["port"]


def _families(text, prefix):
    return [ln for ln in text.splitlines()
            if prefix in ln and "last_fold_seconds" not in ln]


def test_parity_hotspot_metric_families():
    texts = {which: pkg(which, "web").render_metrics([], hotspots=store)
             for which, (store, _, _) in _stores().items()}
    port = _families(texts["port"], "parca_agent_hotspot_")
    assert port and port == _families(texts["jax"], "parca_agent_hotspot_")


def test_parity_hotspot_fold_chaos_counters():
    """The hotspot.fold chaos site under the same seeded rules: the same
    folds fail, the store counts the same errors, answers stay equal."""
    got = {}
    for which in BOTH:
        faults = pkg(which, "utils.faults")
        hot = pkg(which, "runtime.hotspots")
        kw = {} if which == "jax" else {"device": "cpu"}
        agg = pkg(which, "aggregator.dict").DictAggregator(
            capacity=1 << 12, **kw)
        store = hot.HotspotStore(spec=_spec(which), clock=FakeClock())
        faults.install(faults.FaultInjector.from_spec(
            "hotspot.fold:error:p=0.5", seed=11))
        raised = []
        try:
            for w in range(8):
                counts = np.asarray(agg.window_counts(_window(which, w)))
                idx = np.flatnonzero(counts)
                try:
                    store.fold_from_aggregator(hot.RegistryView(agg), idx,
                                               counts[idx], w * SEC, SEC)
                    raised.append(False)
                except Exception:  # noqa: BLE001 - counted and re-raised
                    raised.append(True)
            fired = faults.get().stats()
        finally:
            faults.install(None)
        got[which] = (raised, fired, plain(store.metrics(), TIMINGS),
                      plain(store.query(k=10), TIMINGS))
    assert any(got["port"][0]) and not all(got["port"][0])
    assert got["jax"] == got["port"]
