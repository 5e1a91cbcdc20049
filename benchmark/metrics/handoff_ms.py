"""handoff_ms: the mean per measured window of the capture thread's
hand-off of the closed window to the encode worker (the loop's record of
EncodePipeline.submit, the encoder's prepare inside it)."""

from benchmark.stats import mean


def read(run):
    return mean(run.records[w]["handoff_ms"] for w in run.measured()
                if "handoff_ms" in run.records.get(w, {}))
