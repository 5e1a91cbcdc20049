"""close_ms: the mean per measured window of the feeder's last_close_s
(close_window: the last settle, the pack and the fetch)."""

from benchmark.stats import mean


def read(run):
    return mean(run.records[w]["feeder_s"]["close"] * 1e3
                for w in run.measured()
                if "close" in run.records.get(w, {}).get("feeder_s", {}))
