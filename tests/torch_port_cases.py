"""Run a parca_agent_tpu test module's cases against the port.

``port_cases("test_hotspots", globals())`` reads tests/test_hotspots.py,
points every ``parca_agent_tpu`` import at ``parca_agent_tpu_torch``
(nothing else in the source changes, so line numbers and assertions are
the original's), rewrites its asserts as pytest does, and executes it
into the calling test module: pytest then collects every case, fixture
and parametrization of the original under the caller's file, run
through the port.

The port's entry points run on the card unless the caller asks for the
CPU; ``port_on_cpu`` (an autouse fixture once imported into the test
module) is that ask for every entry point at once: each port module's
``resolve_device`` maps "cuda" to "cpu" for the test's duration.
``jax_style_profiler`` builds the port's window loop from the keyword
arguments parca_agent_tpu's one-class CPUProfiler takes: ``fast_encode``
picks CPUProfiler (with ``encode_pipeline`` as given) or AggregateLoop;
the original's CPU fallback aggregator and device retry clock, which the
port does not have, are dropped.
"""

from __future__ import annotations

import ast
import inspect
import re
import sys
import types
from pathlib import Path

import pytest
import torch
from _pytest.fixtures import FixtureFunctionDefinition

TESTS = Path(__file__).resolve().parent
_PKG = re.compile(r"\bparca_agent_tpu\b")


def port_source(name: str) -> str:
    """tests/<name>.py with its imports pointed at the port; an import
    of the window loop inside a function gets jax_style_profiler."""
    src = _PKG.sub("parca_agent_tpu_torch", (TESTS / f"{name}.py").read_text())
    return src.replace(
        "from parca_agent_tpu_torch.profiler.cpu import CPUProfiler",
        "from torch_port_cases import jax_style_profiler as CPUProfiler")


def port_cases(name: str, namespace: dict, replaced=()) -> types.ModuleType:
    """Execute tests/<name>.py, imports pointed at the port, as a module
    of its own, and hand its cases and fixtures to `namespace` (a test
    module's globals); its module marks go on each case. The cases named
    in `replaced` are left out: the test module defines its own, under
    the same name, where the port rightly differs. Returns the module
    (its helpers are the replacements' too)."""
    path = TESTS / f"{name}.py"
    src = port_source(name)
    tree = ast.parse(src, str(path))
    from _pytest.assertion.rewrite import rewrite_asserts

    rewrite_asserts(tree, src.encode(), path)
    mod = types.ModuleType(f"{namespace['__name__']}.{name}")
    mod.__file__ = str(path)
    sys.modules[mod.__name__] = mod
    exec(compile(tree, str(path), "exec"), mod.__dict__)
    if "CPUProfiler" in mod.__dict__:
        mod.CPUProfiler = jax_style_profiler
    marks = mod.__dict__.get("pytestmark", [])
    marks = marks if isinstance(marks, list) else [marks]
    for key, obj in mod.__dict__.items():
        case = key.startswith("test") and inspect.isfunction(obj)
        if not case and not isinstance(obj, FixtureFunctionDefinition) \
                or key in replaced:
            continue
        if key in namespace:
            raise ValueError(f"{key} is defined twice")
        for mark in marks if case else ():
            obj = mark(obj)
        namespace[key] = obj
    return mod


def _cpu_resolver(real):
    def resolve_device(device="cuda"):
        if torch.device(device).type == "cuda":
            device = "cpu"
        return real(device)

    return resolve_device


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    """Every port entry point asks for the CPU during the test."""
    import pkgutil

    import parca_agent_tpu_torch
    from parca_agent_tpu_torch.utils import device

    for info in pkgutil.walk_packages(parca_agent_tpu_torch.__path__,
                                      "parca_agent_tpu_torch."):
        if info.name.endswith("__main__"):
            continue
        __import__(info.name)
    real = device.resolve_device
    cpu = _cpu_resolver(real)
    for name, mod in list(sys.modules.items()):
        if name.startswith("parca_agent_tpu_torch") \
                and getattr(mod, "resolve_device", None) is real:
            monkeypatch.setattr(mod, "resolve_device", cpu)
    yield


# The original's CPUProfiler arguments the port's loops do not take.
_JAX_ONLY_ARGS = ("fallback_aggregator", "device_retry_windows")


def jax_style_profiler(source=None, aggregator=None, fast_encode=False,
                       encode_pipeline=False, **kw):
    """The port's window loop for parca_agent_tpu CPUProfiler arguments."""
    from parca_agent_tpu_torch.profiler.cpu import AggregateLoop, CPUProfiler

    for k in _JAX_ONLY_ARGS:
        kw.pop(k, None)
    if fast_encode:
        return CPUProfiler(source, aggregator,
                           encode_pipeline=encode_pipeline, **kw)
    return AggregateLoop(source, aggregator, **kw)


# -- comparing the two packages -------------------------------------------------


def pkg(which: str, name: str):
    """Module `name` of parca_agent_tpu ("jax") or of the port ("port")."""
    import importlib

    root = "parca_agent_tpu" if which == "jax" else "parca_agent_tpu_torch"
    return importlib.import_module(f"{root}.{name}")


def plain(obj, drop=()):
    """A value two packages' outputs compare by: arrays as (dtype,
    shape, bytes), containers element by element, other objects by their
    slots or attributes; mapping keys in `drop` (timings) are left out."""
    import numpy as np

    if isinstance(obj, np.ndarray):
        return ("ndarray", obj.dtype.str, obj.shape, obj.tobytes())
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, dict):
        return {k: plain(v, drop) for k, v in obj.items() if k not in drop}
    if isinstance(obj, (list, tuple)):
        return type(obj).__name__, [plain(v, drop) for v in obj]
    if obj is None or isinstance(obj, (bool, int, float, str, bytes)):
        return obj
    slots = [s for c in type(obj).__mro__ for s in getattr(c, "__slots__", ())]
    fields = ({s: getattr(obj, s) for s in slots if hasattr(obj, s)}
              if slots else dict(vars(obj)))
    return type(obj).__name__, plain(fields, drop)


SEC = 1_000_000_000
# The synthetic layout's first shared object: a leaf frame in this range
# belongs to one binary (one build id).
SHIFT_LO = 0x0000_7F00_0000_0000
SHIFT_HI = SHIFT_LO + (1 << 24)


class Collect:
    """A profile writer that keeps every (labels, bytes) it is given."""

    def __init__(self):
        self.got = []

    def write(self, labels, blob):
        self.got.append((dict(labels), bytes(blob)))


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def shifted_windows(which: str, n: int, shift_after: int | None = None,
                    seed: int = 11):
    """`n` windows of one synthetic layout, 10 s apart; from window
    `shift_after` on, the stacks whose leaf is in one binary weigh 8x."""
    import dataclasses

    syn = pkg(which, "capture.synthetic")
    snap = syn.generate(syn.SyntheticSpec(
        n_pids=10, n_unique_stacks=256, n_rows=256, total_samples=2500,
        mean_depth=8, seed=seed))
    out = []
    for w in range(n):
        counts = snap.counts.copy()
        if shift_after is not None and w >= shift_after:
            leaf = snap.stacks[:, 0]
            counts[(leaf >= SHIFT_LO) & (leaf < SHIFT_HI)] *= 8
        out.append(dataclasses.replace(
            snap, counts=counts, time_ns=snap.time_ns + w * 10 * SEC))
    return out


def analytics_run(which: str, root, windows: int = 9,
                  shift_after: int | None = 5, sinks: bool = True,
                  analytics: bool = True, admission=None):
    """The fast window loop of one package over `shifted_windows`, with
    a HotspotStore, a RegressionSentinel (baselines saved under `root`)
    and a sink registry (pprof, AutoFDO into root/afdo, series, alerts
    into root/alerts.jsonl), each window handed to the encode pipeline
    and flushed before the next. Returns a namespace of the parts."""
    import os
    from types import SimpleNamespace

    hot = pkg(which, "runtime.hotspots")
    rg = pkg(which, "runtime.regression")
    sk = pkg(which, "sinks")
    cm = pkg(which, "ops.sketch").CountMinSpec
    os.makedirs(root, exist_ok=True)
    ns = SimpleNamespace(root=str(root), writer=Collect(), store=None,
                         sentinel=None, registry=None)
    if analytics:
        ns.store = hot.HotspotStore(
            spec=hot.HotspotSpec(k=20, candidates=64,
                                 cm=cm(depth=3, width=1 << 10)),
            window_s=10.0, rollup_spans_s=(30.0, 60.0), clock=FakeClock())
        ns.sentinel = rg.RegressionSentinel(
            spec=rg.RegressionSpec(interval_s=10.0, baseline_rollups=3,
                                   min_count=4, save_every=1,
                                   cm=cm(depth=4, width=1 << 10)),
            path=os.path.join(ns.root, "baselines.bin"),
            clock=FakeClock(1_792_000_000.0))
    if sinks:
        afdo = sk.AutoFDOSink(os.path.join(ns.root, "afdo"),
                              flush_windows=2)
        secondaries = [afdo, sk.SeriesSink()]
        if ns.sentinel is not None:
            secondaries.append(sk.AlertsSink(
                os.path.join(ns.root, "alerts.jsonl"),
                sentinel=ns.sentinel))
            ns.sentinel.bind_staleness(afdo.mark_stale)
        ns.registry = sk.SinkRegistry([sk.PprofSink(), *secondaries])
    snaps = shifted_windows(which, windows, shift_after)

    class Source:
        def poll(self):
            return snaps.pop(0) if snaps else None

    kw = {} if which == "jax" else {"device": "cpu"}
    make = (pkg("jax", "profiler.cpu").CPUProfiler if which == "jax"
            else jax_style_profiler)
    ns.agg = pkg(which, "aggregator.dict").DictAggregator(
        capacity=1 << 14, **kw)
    ns.prof = make(source=Source(), aggregator=ns.agg,
                   profile_writer=ns.writer, duration_s=10.0,
                   fast_encode=True, encode_pipeline=True,
                   hotspot_store=ns.store, sinks=ns.registry,
                   regression=ns.sentinel, admission=admission)
    pipe = ns.prof._pipeline
    while ns.prof.run_iteration():
        assert pipe.flush(30)
    assert pipe.close(30)
    if ns.registry is not None:
        ns.registry.close()
    ns.pipeline = pipe
    return ns
