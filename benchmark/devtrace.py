"""Reading the card's timeline out of a torch.profiler trace.

The harness runs the measured interval of a ``--trace 1`` run under
``torch.profiler`` (CPU and CUDA activity) inside one ``bench.measured``
range, and keeps its own host-clock spans of each window, each drain's
generation and feed, and each close (the loop runs feeds and closes on
watchdog threads, which the profiler's ranges do not follow). This
module reads the exported Chrome trace with those spans, placed on the
trace's clock by the ``bench.measured`` range's start: the device's busy
time inside the interval (the union of kernels, copies and memsets), the
device time of the kernels launched inside each feed and each close (a
kernel belongs to the span its launch call ran in, by the launch's
correlation id; the kernel's own start without one), the device
operations that took most time, and the card's idle time inside the
interval split by what the capture thread was doing: in a feed, a close,
the replay's generation, elsewhere in a window (the hand-off, the
collector, the loop's ticks), or between windows.
"""

from __future__ import annotations

import bisect
import json

_DEVICE = {"kernel", "gpu_memcpy", "gpu_memset", "memcpy", "memset"}
_RUNTIME = {"cuda_runtime", "cuda_driver", "runtime", "driver"}
_ANNOTATION = {"user_annotation"}


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class _Ranges:
    """One kind of bench range, sorted by start: which instance holds a
    time."""

    def __init__(self, spans):
        self.spans = sorted(spans)
        self.starts = [s for s, _ in self.spans]

    def index(self, t: float) -> int | None:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t <= self.spans[i][1]:
            return i
        return None


class _Coverage:
    """Length of the union of spans inside any interval."""

    def __init__(self, spans):
        self.spans = _merge(spans)
        self.starts = [a for a, _ in self.spans]
        self.prefix = [0.0]
        for a, b in self.spans:
            self.prefix.append(self.prefix[-1] + (b - a))

    def _upto(self, t: float) -> float:
        i = bisect.bisect_right(self.starts, t)
        if i == 0:
            return 0.0
        a, b = self.spans[i - 1]
        return self.prefix[i - 1] + (min(t, b) - a)

    def overlap(self, a: float, b: float) -> float:
        return self._upto(b) - self._upto(a)


def analyze(path: str, spans: dict, anchor: float, top: int = 10) -> dict:
    """The trace's reading (module docs). ``spans`` maps "feed", "close",
    "gen" and "window" to [(start, end)] host-clock seconds, ``anchor``
    is the host-clock second the ``bench.measured`` range began. Times
    returned are in seconds."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    ann: dict[str, list] = {}
    launch: dict[int, float] = {}
    device = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = str(e.get("cat", "")).lower()
        ts = float(e.get("ts", 0.0))
        end = ts + float(e.get("dur", 0.0))
        args = e.get("args") or {}
        if cat in _ANNOTATION and e.get("name") == "bench.measured":
            ann.setdefault(e["name"], []).append((ts, end))
        elif cat in _RUNTIME and "correlation" in args:
            launch[int(args["correlation"])] = ts
        elif cat in _DEVICE:
            device.append((cat, str(e.get("name", "")), ts, end,
                           args.get("correlation")))
    measured = ann.get("bench.measured")
    if not measured:
        raise ValueError("the trace has no bench.measured range")
    w0, w1 = measured[0]
    for name, host in spans.items():
        ann["bench." + name] = [(w0 + (a - anchor) * 1e6,
                                 w0 + (b - anchor) * 1e6) for a, b in host]
    busy = _merge([(max(a, w0), min(b, w1)) for _, _, a, b, _ in device
                   if b > w0 and a < w1])
    busy_us = sum(b - a for a, b in busy)
    by_name: dict[str, float] = {}
    for _, name, a, b, _ in device:
        if b > w0 and a < w1:
            by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]

    ranges = {name: _Ranges(spans) for name, spans in ann.items()}
    per_range = {name: [0.0] * len(r.spans) for name, r in ranges.items()}
    for cat, _, a, b, corr in device:
        if cat != "kernel":
            continue
        t = launch.get(int(corr), a) if corr is not None else a
        for name in ("bench.feed", "bench.close"):
            r = ranges.get(name)
            i = r.index(t) if r is not None else None
            if i is not None:
                per_range[name][i] += (b - a) / 1e6
                break

    # Idle time inside the interval, by what the capture thread was doing
    # (feeds, closes and generation are disjoint, inside windows).
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    cover = {name: _Coverage(ann.get(name, []))
             for name in ("bench.feed", "bench.close", "bench.gen",
                          "bench.window")}
    idle_by = {}
    for a, b in gaps:
        inner = 0.0
        for name in ("bench.feed", "bench.close", "bench.gen"):
            ov = cover[name].overlap(a, b)
            inner += ov
            idle_by[name[len("bench."):]] = idle_by.get(
                name[len("bench."):], 0.0) + ov
        win = cover["bench.window"].overlap(a, b)
        idle_by["window_other"] = idle_by.get("window_other", 0.0) + max(
            0.0, win - inner)
        idle_by["between_windows"] = idle_by.get(
            "between_windows", 0.0) + max(0.0, (b - a) - win)
    idle = sorted(([k, v / 1e6] for k, v in idle_by.items() if v > 0),
                  key=lambda kv: -kv[1])[:top]
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy_us / 1e6,
            "feed_device_s": per_range.get("bench.feed", []),
            "close_device_s": per_range.get("bench.close", []),
            "device_ops": [[n, s] for n, s in ops], "idle_gaps": idle}
