"""The metric readers' arithmetic on a run built by hand."""

import pytest

from benchmark import manifest, roofline, stats
from benchmark.harness import Run


def _run():
    run = Run(seconds=10.0, t_start=100.0, cpu_start=50.0, first_measured=3)
    # Windows 3..6 measured; 6 completes after the interval (t 110).
    for w, (close, done, cpu) in enumerate(
            [(101.0, 102.0, 53.0), (103.0, 104.5, 56.0),
             (105.0, 109.0, 60.0), (109.5, 111.0, 64.0)], start=3):
        run.close_start[w] = close
        run.done[w] = done
        run.samples[w] = 1_000_000
        run.records[w] = {"cpu": cpu, "mass": 1_000_000, "encode_ms": w,
                          "handoff_ms": 2.0 * w,
                          "feeder_s": {"settle": 0.001 * w,
                                       "close": 0.01 * w}}
    run.close_start[2], run.done[2] = 99.0, 100.5     # a warm window
    run.gen_cpu = [(99.0, 5.0), (101.0, 0.5), (103.0, 0.5), (110.0, 1.0)]
    run.drains = [(3 + i // 25, i / 1000.0, 100 + i % 25 * 4)
                  for i in range(100)]
    run.window_rows = {w: 1000 + w for w in range(3, 7)}
    run.counters_start = {"carry_hits": 10, "carry_rows_in": 20}
    run.counters_end = {"carry_hits": 85, "carry_rows_in": 120}
    run.setup_s = 42.5
    run.trace = {"window_s": 10.0, "busy_s": 0.25,
                 "feed_device_s": [0.0] * 99 + [2e-6],
                 "close_device_s": [1e-6, 0.0, 1e-6, 1e-6]}
    return run


def read(name, run):
    return manifest.reader(name).read(run)


def test_rate_over_completed_windows():
    run = _run()
    assert run.counted() == [3, 4, 5]
    assert read("samples_per_s", run) == pytest.approx(3e6 / 9.0)


def test_window_to_pprof_mean_over_closed_windows():
    assert read("window_to_pprof_ms", _run()) == pytest.approx(
        (1000 + 1500 + 4000 + 1500) / 4)


def test_agent_cpu_less_generation():
    # CPU 60 - 50 at window 5's completion, less 1.0 s of generation in
    # the interval, over 3 Msamples.
    assert read("agent_cpu_s_per_msample", _run()) == pytest.approx(9 / 3)


def test_p95_and_means():
    run = _run()
    assert read("feed_ms_p95", run) == pytest.approx(94.0)
    assert stats.percentile(list(range(1, 21)), 95) == 19
    assert stats.percentile([5.0], 95) == 5.0
    assert read("settle_ms", run) == pytest.approx(4.5)
    assert read("close_ms", run) == pytest.approx(45.0)
    assert read("encode_ms", run) == pytest.approx(4.5)
    assert read("handoff_ms", run) == pytest.approx(9.0)
    assert read("setup_s", run) == 42.5
    assert read("carry_hit_pct", run) == pytest.approx(75.0)
    assert read("device_idle_pct", run) == pytest.approx(97.5)


def test_rooflines_count_the_drains_distinct_rows():
    run = _run()
    assert roofline.feed_bytes(100) == 2400
    assert roofline.close_bytes(1000) == 12000
    # Only the last drain (its 196 distinct rows) launched a kernel.
    assert read("feed_roofline_pct", run) == pytest.approx(
        196 * 24 / 3.35e12 / 2e-6 * 100)
    # Windows 3, 5 and 6 launched a close: their distinct rows, each
    # counted once however many drains carried it.
    assert read("close_roofline_pct", run) == pytest.approx(
        (1003 + 1005 + 1006) * 12 / 3.35e12 / 3e-6 * 100)


def test_readers_find_nothing_without_a_trace_or_work():
    run = _run()
    run.trace = None
    for name in ("feed_roofline_pct", "close_roofline_pct",
                 "device_idle_pct"):
        assert read(name, run) is None
    run.counters_end = dict(run.counters_start)
    assert read("carry_hit_pct", run) is None
    for w in run.records:
        run.records[w]["feeder_s"]["settle"] = 0.0
    assert read("settle_ms", run) is None
    empty = Run(seconds=1.0)
    assert read("samples_per_s", empty) is None
    assert read("agent_cpu_s_per_msample", empty) is None
