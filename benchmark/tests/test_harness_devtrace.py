"""The trace reader on a Chrome trace written by hand."""

import json

import pytest

from benchmark import devtrace


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def test_busy_attribution_and_idle(tmp_path):
    events = [
        _x("user_annotation", "bench.measured", 5000, 1000),
        _x("cuda_runtime", "cudaLaunchKernel", 5150, 5, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 5510, 5, correlation=2),
        _x("kernel", "probe_kernel", 5160, 10, correlation=1),
        _x("kernel", "close_pack_kernel", 5520, 4, correlation=2),
        _x("gpu_memcpy", "Memcpy HtoD", 5155, 5, correlation=3),
        _x("kernel", "outside", 6200, 50, correlation=4)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    # Host-clock spans, in seconds, the interval starting at 7.0 s.
    spans = {"window": [(7.0, 7.0006)], "gen": [(7.0, 7.0001)],
             "feed": [(7.0001, 7.0003), (7.0003, 7.0005)],
             "close": [(7.0005, 7.00055)]}
    t = devtrace.analyze(str(path), spans, 7.0)
    assert t["window_s"] == pytest.approx(1000e-6)
    assert t["busy_s"] == pytest.approx(19e-6)   # 155..170 and 520..524
    assert t["feed_device_s"] == [pytest.approx(10e-6), 0.0]
    assert t["close_device_s"] == [pytest.approx(4e-6)]
    assert t["device_ops"][0] == ["probe_kernel", pytest.approx(10e-6)]
    idle = dict(t["idle_gaps"])
    assert idle["gen"] == pytest.approx(100e-6)
    assert idle["feed"] == pytest.approx(400e-6 - 15e-6)
    assert idle["close"] == pytest.approx(50e-6 - 4e-6)
    assert idle["window_other"] == pytest.approx(50e-6)
    assert idle["between_windows"] == pytest.approx(400e-6)
    assert sum(idle.values()) == pytest.approx(1000e-6 - 19e-6)
