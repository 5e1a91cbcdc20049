"""feed_ms_p95: the 95th percentile of the benchmark's own timer around
each on_drain of the measured windows (the feeder's whole drain tee)."""

from benchmark.stats import percentile


def read(run):
    return percentile([dt * 1e3 for _, dt, *_ in run.drains], 95)
