"""Time the dictionary's cold window (and, with --encode, the window
encoder) on the host, at bench.py's window spec cut to --rows rows.

    python -m parca_agent_tpu_torch.tools.cold_window [--rows 131072]
        [--pids 50000] [--device cuda|cpu] [--encode]
        [--statics-cache-bytes N] [--invalidate K] [--profile N]

The aggregation runs on the CUDA card unless --device cpu is given.
Prints one JSON line: the spec, the cold `window_counts` wall time with
the aggregator's stage timings, and with --encode the window encoder's
cold encode (statics build included) and a steady re-encode of the same
counts, each with the encoder's own timings. --invalidate K then drops K
pids spread over the pid range (invalidate_pid, one id compaction
each), aggregates the window again (the dropped pids register afresh)
and times the long-lived encoder's encode of it against a fresh
encoder's, which must give the same bytes. --profile N adds the N
functions of the cold window with the most own time (cProfile).

Run it from any checkout by file path (`python
.../tools/cold_window.py`) to time that checkout's package: the package
is imported from PYTHONPATH, so the same script times an older tree.
"""

from __future__ import annotations

import argparse
import json
import time


def _encode(enc, counts, snap, shift: int = 0):
    """(blobs, wall ms, the encoder's timings in ms)."""
    t0 = time.perf_counter()
    blobs = enc.encode(counts, snap.time_ns + shift, snap.window_ns,
                       snap.period_ns)
    ms = (time.perf_counter() - t0) * 1e3
    return blobs, ms, {k: v * 1e3 for k, v in enc.timings.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=1 << 17)
    ap.add_argument("--pids", type=int, default=50_000)
    ap.add_argument("--capacity", type=int, default=1 << 21)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--encode", action="store_true")
    ap.add_argument("--statics-cache-bytes", type=int, default=256 << 20)
    ap.add_argument("--invalidate", type=int, default=0)
    ap.add_argument("--profile", type=int, default=0)
    opts = ap.parse_args(argv)
    if opts.invalidate and not opts.encode:
        ap.error("--invalidate needs --encode")

    import numpy as np

    from parca_agent_tpu_torch.aggregator.dict import DictAggregator
    from parca_agent_tpu_torch.capture.synthetic import SyntheticSpec, generate
    from parca_agent_tpu_torch.utils.device import resolve_device

    device = resolve_device(opts.device)
    t0 = time.perf_counter()
    snap = generate(SyntheticSpec(
        n_pids=opts.pids, n_unique_stacks=opts.rows, n_rows=opts.rows,
        total_samples=max(5_000_000, opts.rows + 1), mean_depth=24,
        kernel_fraction=0.2, seed=42))
    out = {"rows": len(snap), "pids": opts.pids, "device": str(device),
           "generate_s": time.perf_counter() - t0}
    agg = DictAggregator(capacity=opts.capacity, overflow="raise",
                         device=device)
    hashes = agg.hash_rows(snap)
    prof = None
    if opts.profile:
        import cProfile

        prof = cProfile.Profile()
        prof.enable()
    t0 = time.perf_counter()
    counts = agg.window_counts(snap, hashes)
    out["cold_window_ms"] = (time.perf_counter() - t0) * 1e3
    if prof is not None:
        import pstats

        prof.disable()
        st = pstats.Stats(prof)
        top = sorted(st.stats.items(), key=lambda kv: -kv[1][2])
        out["top_own_s"] = [
            [f"{fn[0].rsplit('/', 1)[-1]}:{fn[1]}:{fn[2]}", row[2]]
            for fn, row in top[:opts.profile]]
    out["cold_timings_ms"] = {k: v * 1e3 for k, v in agg.timings.items()}
    out["inserts"] = agg.stats["inserts"]
    if int(counts.sum()) != snap.total_samples():
        raise AssertionError("cold window lost mass")
    if opts.encode:
        from parca_agent_tpu_torch.pprof.window_encoder import WindowEncoder

        enc = WindowEncoder(agg,
                            statics_cache_bytes=opts.statics_cache_bytes)
        for name in ("cold", "steady"):
            blobs, ms, timings = _encode(enc, counts, snap)
            out[f"encode_{name}_ms"] = ms
            out[f"encode_{name}_timings_ms"] = timings
        out["encode_pids"] = len(blobs)
        out["encode_bytes"] = sum(len(b) for _, b in blobs)
        out["statics_cache_bytes"] = enc.stats["statics_cache_bytes"]
        del blobs
    if opts.invalidate:
        pids = np.unique(snap.pids)
        drop = pids[np.linspace(0, len(pids) - 1,
                                opts.invalidate).astype(int)]
        t0 = time.perf_counter()
        if not all(agg.invalidate_pid(int(p)) for p in drop):
            raise AssertionError("invalidate_pid deferred at a boundary")
        out["invalidate_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        counts = agg.window_counts(snap, hashes)
        out["window_after_ms"] = (time.perf_counter() - t0) * 1e3
        if int(counts.sum()) != snap.total_samples():
            raise AssertionError("the window after lost mass")
        out["registry_epoch"] = agg.registry_epoch
        keys = ("statics_cache_hits", "statics_cache_misses",
                "statics_cache_evictions", "statics_bytes_built",
                "statics_bytes_reused")
        before = {k: enc.stats[k] for k in keys}
        blobs, ms, timings = _encode(enc, counts, snap, 1)
        out["encode_after_ms"] = ms
        out["encode_after_timings_ms"] = timings
        out["encode_after_stats"] = {k: enc.stats[k] - before[k]
                                     for k in keys}
        fresh, ms, timings = _encode(WindowEncoder(agg), counts, snap, 1)
        out["fresh_encode_ms"] = ms
        out["fresh_encode_timings_ms"] = timings
        if sorted(fresh) != sorted(blobs):
            raise AssertionError("the long-lived encoder != a fresh one")
        del blobs, fresh
        _, ms, _ = _encode(enc, counts, snap, 2)
        out["encode_steady_after_ms"] = ms
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
