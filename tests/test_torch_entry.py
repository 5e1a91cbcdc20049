"""The port as a user meets it: its import boundary and its command line.

The port imports torch and never jax or parca_agent_tpu; its entry point
runs on the CPU only when asked to, and otherwise needs a CUDA device.
"""

import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import parca_agent_tpu_torch
from parca_agent_tpu_torch.pprof.builder import parse_pprof

# One intra-op thread a process: the suite runs in several worker
# processes at once, and torch's default of a thread a core in each
# oversubscribes the host, so that timing-bound tests in other workers
# (an encode pipeline busy at a window's close) take another path.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _env():
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"  # as torch.set_num_threads(1) above
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


def test_port_imports_neither_jax_nor_the_jax_package():
    names = ["parca_agent_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(
            parca_agent_tpu_torch.__path__, "parca_agent_tpu_torch.")]
    assert "parca_agent_tpu_torch.aggregator.dict" in names
    assert "parca_agent_tpu_torch.aggregator.probe" in names
    assert "parca_agent_tpu_torch.aggregator.tpu" in names
    assert "parca_agent_tpu_torch.ops.row_hash" in names
    assert "parca_agent_tpu_torch.aggregator.close" in names
    assert "parca_agent_tpu_torch.aggregator.sharded" in names
    assert "parca_agent_tpu_torch.ops.sketch" in names
    assert "parca_agent_tpu_torch.utils.window_clock" in names
    for mod in ("pprof.window_encoder", "pprof.vec",
                "profiler.encode_pipeline", "profiler.cpu",
                "runtime.trace", "utils.log", "tools.cold_window",
                "process.maps", "capture.live", "pprof.statics_store",
                "profiler.streaming", "parallel", "parallel.mesh",
                "parallel.fleet", "parallel.distributed", "utils.bounded",
                "native", "utils.vfs", "utils.poison", "utils.filehash",
                "utils.faults", "elf", "elf.base", "elf.buildid",
                "elf.reader", "process.objectfile", "capture.procfs",
                "elf.executable", "elf.writer", "dwarf", "dwarf.frame",
                "unwind", "unwind.table", "unwind.walker", "symbolize",
                "symbolize.ksym", "symbolize.perfmap",
                "symbolize.symbolizer", "process.identity", "debuginfo",
                "debuginfo.find", "debuginfo.extract", "debuginfo.manager",
                "agent", "agent.writer", "agent.profilestore",
                "agent.listener", "agent.spool", "agent.batch",
                "agent.grpc_client", "agent.debuginfo_client", "labels",
                "labels.relabel", "labels.manager", "metadata",
                "metadata.providers", "config", "web", "buildinfo",
                "kconfig", "discovery", "discovery.manager",
                "discovery.cgroup", "discovery.systemd", "discovery.cri",
                "discovery.kubernetes", "profiler.selfprofile",
                "runtime.admission", "runtime.hotspots",
                "runtime.regression", "sinks", "sinks.base", "sinks.pprof",
                "sinks.registry", "sinks.autofdo", "sinks.series",
                "sinks.alerts"):
        assert "parca_agent_tpu_torch." + mod in names
    code = (
        "import importlib, sys\n"
        f"names = {names!r}\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'parca_agent_tpu'\n"
        "             or m.startswith('parca_agent_tpu.'))\n"
        "assert 'torch' in sys.modules\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_cli_on_cpu_writes_profiles(tmp_path):
    store = tmp_path / "store"
    r = subprocess.run(
        [sys.executable, "-m", "parca_agent_tpu_torch", "--device", "cpu",
         "--http-address", "127.0.0.1:0",
         "--capture", "synthetic", "--windows", "2",
         "--profiling-duration", "0.1",
         "--local-store-directory", str(store)],
        env=_env(), cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stderr
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
    assert sum('"window"' in ln for ln in lines) == 2
    assert "runtime" in json.loads(lines[-1])
    files = sorted(store.glob("*.pb.gz"))
    assert len(files) >= 2
    prof = parse_pprof(files[0].read_bytes())
    assert prof.samples and all(v[0] > 0 for _, v, _ in prof.samples)


def test_cli_on_cpu_with_the_one_shot_aggregator(tmp_path):
    """--aggregator tpu: every window's profiles land in the store and
    parse back to the window's mass (the synthetic source's 1M samples)."""
    store = tmp_path / "store"
    r = subprocess.run(
        [sys.executable, "-m", "parca_agent_tpu_torch", "--device", "cpu",
         "--http-address", "127.0.0.1:0",
         "--capture", "synthetic", "--aggregator", "tpu", "--windows", "2",
         "--profiling-duration", "0.1",
         "--local-store-directory", str(store)],
        env=_env(), cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stderr
    lines = [json.loads(ln) for ln in r.stdout.splitlines()
             if ln.startswith("{") and '"window"' in ln]
    assert [ln["aggregator"] for ln in lines] == ["tpu", "tpu"]
    files = sorted(store.glob("*.pb.gz"))
    assert len(files) == sum(ln["profiles"] for ln in lines)
    mass = sum(v[0] for f in files
               for _, v, _ in parse_pprof(f.read_bytes()).samples)
    assert mass == sum(ln["samples"] for ln in lines)


def test_cli_on_cpu_with_the_bounded_memory_dictionary(tmp_path):
    """--aggregator dict+cm at a capacity below the synthetic windows'
    10,000 stacks: the dictionary fills, the overflow degrades to the
    sketch instead of stopping the run, and the exact part lands in the
    store as profiles."""
    store = tmp_path / "store"
    r = subprocess.run(
        [sys.executable, "-m", "parca_agent_tpu_torch", "--device", "cpu",
         "--http-address", "127.0.0.1:0",
         "--capture", "synthetic", "--aggregator", "dict+cm",
         "--aggregator-capacity", "4096", "--windows", "3",
         "--profiling-duration", "0.1",
         "--local-store-directory", str(store)],
        env=_env(), cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stderr
    lines = [json.loads(ln) for ln in r.stdout.splitlines()
             if ln.startswith("{") and '"window"' in ln]
    assert [ln["aggregator"] for ln in lines] == ["dict+cm"] * 3
    files = sorted(store.glob("*.pb.gz"))
    assert len(files) == sum(ln["profiles"] for ln in lines)
    mass = sum(v[0] for f in files
               for _, v, _ in parse_pprof(f.read_bytes()).samples)
    assert 0 < mass < sum(ln["samples"] for ln in lines)


def test_cli_without_cuda_names_the_missing_device(tmp_path):
    _assert_cli_needs_cuda(tmp_path, "dict")


def test_cli_dict_cm_without_cuda_names_the_missing_device(tmp_path):
    _assert_cli_needs_cuda(tmp_path, "dict+cm")


def test_cli_sharded_without_cuda_names_the_missing_device(tmp_path):
    _assert_cli_needs_cuda(tmp_path, "sharded")


def _assert_cli_needs_cuda(tmp_path, aggregator: str):
    """On a host without a CUDA device the default --device cuda must
    stop with an error, not carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    r = subprocess.run(
        [sys.executable, "-m", "parca_agent_tpu_torch",
         "--http-address", "127.0.0.1:0", "--capture",
         "synthetic", "--aggregator", aggregator, "--windows", "1",
         "--local-store-directory", str(tmp_path / "store")],
        env=_env(), cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert r.returncode != 0
    assert "CUDA" in r.stderr and "device" in r.stderr
    assert not (tmp_path / "store").exists()
