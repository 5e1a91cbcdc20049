"""window_to_pprof_ms: the mean, over every window whose close started in
the measured interval, of the time from the start of its close to its
last pid's pprof at the writer (host clock)."""

from benchmark.stats import mean


def read(run):
    return mean((run.done[w] - run.close_start[w]) * 1e3
                for w in run.closed_in_interval() if w in run.done)
