"""encode_ms: the mean per measured window of the encode worker's time
for the window (the loop's record of the pipeline's last_encode_s)."""

from benchmark.stats import mean


def read(run):
    return mean(run.records[w]["encode_ms"] for w in run.measured()
                if w in run.records)
