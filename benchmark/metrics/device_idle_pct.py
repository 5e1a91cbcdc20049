"""device_idle_pct: the share of the traced measured interval in which no
kernel, copy or memset ran on the card (torch.profiler's timeline)."""


def read(run):
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    t = run.trace
    return (1.0 - t["busy_s"] / t["window_s"]) * 100.0
