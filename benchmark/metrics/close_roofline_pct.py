"""close_roofline_pct: over the measured windows whose close launched a
kernel, the least time their closes need at the card's bandwidth
(roofline.close_bytes of the window's distinct (pid, stack) rows: each
count read once and written once to the packed buffer, whatever
implements the close) over the device time of the kernels launched
inside those closes (torch.profiler). None when no close launched one."""

from benchmark import roofline


def read(run):
    if run.trace is None:
        return None
    pairs = [(run.window_rows.get(w, 0), dev) for w, dev in
             zip(run.measured(), run.trace["close_device_s"]) if dev > 0]
    return roofline.share_pct(sum(roofline.close_bytes(r) for r, _ in pairs),
                              sum(d for _, d in pairs))
