"""settle_ms: the mean per measured window of the feeder's
last_window_settle_s (the deferred miss checks and their settles). None
when no measured window settled anything (every row carried)."""

from benchmark.stats import mean


def read(run):
    values = [run.records[w]["feeder_s"].get("settle", 0.0) * 1e3
              for w in run.measured() if w in run.records]
    return mean(values) if any(values) else None
