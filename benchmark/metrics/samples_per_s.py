"""samples_per_s: the samples of every window whose pprof all reached the
writer inside the measured interval, over the time from the interval's
start to the last such window's completion (host clock)."""


def read(run):
    counted = run.counted()
    if not counted:
        return None
    span = run.done[counted[-1]] - run.t_start
    return sum(run.samples[w] for w in counted) / span
