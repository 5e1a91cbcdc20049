"""Run one cell of BENCHMARK.json once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Needs a CUDA card (as many as the cell names) and the port,
parca_agent_tpu_torch, in the checkout; without either it exits nonzero
and prints no result. Earlier stdout lines carry the set-up's parts and
the run's details; the last stdout line is the result; the last stderr
lines are the output check's numbers, each with its limit. With
``--trace 1`` the metrics are the cell's per-layer ones, read from a
torch.profiler trace of the measured interval; otherwise its end-to-end
ones. A run that loads jax, jaxlib, flax or parca_agent_tpu exits
nonzero with no result.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

_T0 = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent
# Fixed cache directories inside the checkout, so that only the first run
# of a checkout builds (the port's nvcc builds go to its own build/).
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = str(ROOT / ".bench_cache" / _sub)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import benchmark  # noqa: E402

benchmark.one_thread_pools()
from benchmark import harness, manifest  # noqa: E402


def process_age() -> float:
    """Seconds since this process started (the kernel's start time, in
    clock ticks since boot, against the uptime)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


def power_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().splitlines()[0] if r.stdout.strip() else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def read_metrics(metrics: list[dict], run) -> dict:
    out = {}
    for m in metrics:
        value = manifest.reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(out: dict, check: dict, metrics: dict, kind: str,
                chips: int, trace: bool) -> dict:
    device = {"platform": "gpu", "kind": kind, "count": chips,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": all(v == 0 for v in check["numbers"].values()),
            "attempted": check["windows"], "failed": check["failed"],
            "metrics": metrics, "device": device}
    t = out["run"].trace
    if trace and t is not None:
        device["busy_s"] = t["busy_s"]
        device["window_s"] = t["window_s"]
        line["breakdown"] = {"device_ops": t["device_ops"],
                             "idle_gaps": t["idle_gaps"]}
    line["checks"] = {k: {"value": v, "limit": 0}
                      for k, v in check["numbers"].items()}
    return line


def details(out: dict, check: dict, power: str) -> dict:
    run = out["run"]
    drains = [d[2] for d in run.drains]
    return {"power": power, "setup_parts_s": out["setup_parts"],
            "setup_s": run.setup_s,
            "windows_measured": len(run.measured()),
            "windows_counted": len(run.counted()),
            "drains_measured": len(run.drains),
            "rows_per_drain_max": max(drains) if drains else 0,
            "rows_per_drain_mean": (sum(drains) / len(drains)
                                    if drains else 0),
            "pprof_bytes_per_window": (
                sum(out["sink"].bytes[w] for w in run.measured()
                    if w in out["sink"].bytes)
                / max(1, len(run.measured()))),
            "window_gaps_s": [
                run.close_start[b] - run.close_start[a]
                for a, b in zip(run.measured(), run.measured()[1:])],
            "to_pprof_s": [run.done[w] - run.close_start[w]
                           for w in run.measured() if w in run.done],
            "feeder_s": [run.records[w]["feeder_s"] for w in run.measured()
                         if w in run.records],
            "counters": run.counters_end, "windows_checked": check["windows"]}


def evaluate(man: dict, cell: dict, seed: int, seconds: float,
             trace: bool, device: str = "cuda", kind: str = "",
             cfg: dict | None = None, mix: dict | None = None):
    """Run the cell once, check its outputs and read its metrics: (the
    result line, the details line), or None when a forbidden module was
    loaded (named on stderr)."""
    cfg = cfg or manifest.config(man, cell["config"])
    mix = mix or manifest.traffic(cell["traffic"])
    reference = manifest.reference(cfg["reference"])
    out = harness.run_cell(cfg, mix, seed, seconds, trace, device=device,
                           process_age=process_age)
    # The window has closed and the loop is stopped: the check runs now.
    check = harness.check_outputs(out, reference)
    found = harness.forbidden_modules()
    if found:
        print("forbidden modules loaded: " + ", ".join(found),
              file=sys.stderr)
        return None
    metrics = read_metrics(manifest.metrics_for(man, cell["name"], trace),
                           out["run"])
    line = result_line(out, check, metrics, kind, int(cell["chips"]), trace)
    return line, details(out, check, power_line() if device == "cuda"
                         else "")


def main(argv=None) -> int:
    args = parse(argv)
    man = manifest.load()
    cell = manifest.cell(man, args.workload)
    chips = int(cell["chips"])
    if importlib.util.find_spec("parca_agent_tpu_torch") is None:
        print("parca_agent_tpu_torch is not in this checkout",
              file=sys.stderr)
        return 2
    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"needs {chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    got = evaluate(man, cell, args.seed, args.seconds, bool(args.trace),
                   kind=torch.cuda.get_device_name(0))
    if got is None:
        return 3
    line, detail = got
    print(json.dumps({"details": detail}), flush=True)
    for name, v in line["checks"].items():
        print(f"check {name} = {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
