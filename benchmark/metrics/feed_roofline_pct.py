"""feed_roofline_pct: over the measured drains whose feed launched a
kernel, the least time their distinct rows need at the card's bandwidth
(roofline.feed_bytes: each row's key read once, its count read and
written once, whatever implements the feed) over the device time of the
kernels launched inside those feeds (torch.profiler). None when no feed
launched a kernel."""

from benchmark import roofline


def read(run):
    if run.trace is None:
        return None
    pairs = [(rows, dev) for (_, _, rows), dev in
             zip(run.drains, run.trace["feed_device_s"]) if dev > 0]
    return roofline.share_pct(sum(roofline.feed_bytes(r) for r, _ in pairs),
                              sum(d for _, d in pairs))
