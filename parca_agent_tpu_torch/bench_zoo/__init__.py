"""Workload zoo: scenario breadth as a scored matrix.

The port's copy of parca_agent_tpu/bench_zoo. Seeded, deterministic
hostile-world scenarios (pid reuse under tenant migration, JIT perf-map
churn, fork/exec storms, deep stacks, kernel-heavy mixes, multi-tenant
bursts), each driven through the port's window loop — its dictionary on
the card unless the caller passes ``device="cpu"`` — and scored against
per-scenario bars. Entry points: ``build_schedule`` (deterministic
sweep plan), ``run_scenario`` (one matrix row: path x cadence x
optional device outage), ``run_zoo`` (the scalar matrix), ``run_matrix``
(the full endurance matrix) and ``run_soak`` (bench_zoo/soak.py:
wall-time endurance with RSS/byte-lane verdicts). See
docs/robustness.md's endurance-matrix section; the port's outage rows
score its own device health (bench_zoo/runner.py).
"""

from parca_agent_tpu_torch.bench_zoo.runner import (
    CADENCES, OUTAGES, PATHS, run_matrix, run_scenario, run_zoo)
from parca_agent_tpu_torch.bench_zoo.scenarios import (
    SCENARIOS, Scenario, ZooWindow, build_schedule, make_snapshot)
from parca_agent_tpu_torch.bench_zoo.soak import run_soak

__all__ = [
    "CADENCES", "OUTAGES", "PATHS", "SCENARIOS", "Scenario", "ZooWindow",
    "build_schedule", "make_snapshot", "run_matrix", "run_scenario",
    "run_soak", "run_zoo",
]
