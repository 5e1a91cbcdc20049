"""The port's tools (tools/) held to parca_agent_tpu's.

Every case of tests/test_tools.py runs here through the port
(tests/torch_port_cases.py), with the original's assertions. Below them,
the three text tools print the same text as the original's for the same
input — a saved window (snapshot), a written profile, gzipped once,
twice or not at all (pprof_dump), and the fixture binaries' unwind
tables (eh_frame). The three smokes drive the port's window loop and
web.py on the CPU (``--device cpu``) and pass; asked for the card where
there is none, a smoke fails rather than fall back.
"""

from __future__ import annotations

import contextlib
import gzip
import io
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_port_cases import (  # noqa: E402
    pkg,
    port_cases,
    port_on_cpu,  # noqa: F401 - autouse fixture
)

port_cases("test_tools", globals())

BOTH = ("jax", "port")
REPO = Path(__file__).resolve().parent.parent
FIXDIR = REPO / "tests" / "fixtures"


def _main_out(which, tool, argv):
    """(exit code, stdout, stderr) of one package's tools.<tool>.main."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = pkg(which, f"tools.{tool}").main([str(a) for a in argv])
    return rc, out.getvalue(), err.getvalue()


def _synthetic(which, seed, **kw):
    syn = pkg(which, "capture.synthetic")
    return syn.generate(syn.SyntheticSpec(seed=seed, **kw))


@pytest.mark.parametrize("seed,kw", [
    (2, dict(n_pids=7, n_unique_stacks=50)),
    (5, dict(n_pids=40, n_unique_stacks=600, n_rows=900,
             kernel_fraction=0.3)),
    (9, dict(n_pids=1, n_unique_stacks=3, n_rows=3, total_samples=3)),
])
def test_parity_snapshot_tool_text(seed, kw, tmp_path):
    out = {}
    for which in BOTH:
        snap = _synthetic(which, seed, **kw)
        path = tmp_path / f"{which}.snap"
        pkg(which, "capture.formats").save_snapshot(snap, str(path))
        out[which] = (
            _main_out(which, "snapshot", [path, "--top", "3", "--pids", "4"]),
            _main_out(which, "snapshot", [path]),
            pkg(which, "tools.snapshot").format_summary(snap, top=7, pids=2))
    assert out["jax"] == out["port"]
    assert out["port"][0][0] == 0


@pytest.mark.parametrize("layers", [0, 1, 2])
def test_parity_pprof_dump_text(layers, tmp_path):
    """A profile each package built from the same window, gzipped
    `layers` times: the same text, and each package's bytes print the
    same through the other's tool."""
    blobs = {}
    for which in BOTH:
        snap = _synthetic(which, 4, n_pids=3, n_unique_stacks=80,
                          total_samples=900, kernel_fraction=0.2)
        prof = pkg(which, "aggregator.cpu").CPUAggregator().aggregate(snap)[1]
        blob = pkg(which, "pprof.builder").build_pprof(prof, compress=False)
        for _ in range(layers):
            blob = gzip.compress(blob, mtime=0)
        blobs[which] = blob
    assert blobs["jax"] == blobs["port"]
    path = tmp_path / "p.pb"
    path.write_bytes(blobs["port"])
    out = {which: (_main_out(which, "pprof_dump", [path, "--top", "4"]),
                   _main_out(which, "pprof_dump", [path]))
           for which in BOTH}
    assert out["jax"] == out["port"]
    assert "top 4 stacks:" in out["port"][0][1]


@pytest.mark.parametrize("name", ["fixture_nopie", "fixture_pie",
                                  "fixture_pie_nofp", "fixture_plt"])
def test_parity_eh_frame_tool_text(name):
    out = {which: _main_out(which, "eh_frame", [FIXDIR / name])
           for which in BOTH}
    assert out["jax"] == out["port"]
    rc, text, _ = out["port"]
    assert rc == 0 and text.splitlines()[0].endswith(" rows")


def test_parity_eh_frame_tool_without_a_section(tmp_path):
    """A binary with no .eh_frame: exit 1 and the same message."""
    from parca_agent_tpu_torch.elf.reader import ET_DYN
    from parca_agent_tpu_torch.elf.writer import ElfWriter

    path = tmp_path / "bare"
    path.write_bytes(ElfWriter(ET_DYN, 62).serialize())
    out = {which: _main_out(which, "eh_frame", [path]) for which in BOTH}
    assert out["jax"] == out["port"]
    assert out["port"][0] == 1


# -- the smokes -------------------------------------------------------------


def _smoke(tool, *args):
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return subprocess.run(
        [sys.executable, "-m", f"parca_agent_tpu_torch.tools.{tool}", *args],
        capture_output=True, text=True, cwd=str(REPO), env=env, timeout=300)


@pytest.mark.parametrize("tool", ["trace_smoke", "hotspot_smoke",
                                  "regress_smoke"])
def test_smoke_passes_on_the_cpu(tool):
    r = _smoke(tool, "--device", "cpu")
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    assert r.stdout.strip().splitlines()[-1].endswith(": PASS")


def test_smoke_without_the_card_fails_rather_than_fall_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the smoke would run on it")
    r = _smoke("hotspot_smoke")
    assert r.returncode != 0
    assert "PASS" not in r.stdout
    assert "CUDA" in r.stderr
