"""The output check's control, several seeds in one process, on a CUDA
card (the benchmark's own runs do not run it).

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3
        --seconds <s>

It runs the cell at its own size with the dictionary's capacity cut to
the largest power of two at or below the cell's live stacks, whose ids
hold at most half of them: the dict+cm path then absorbs samples into
its count-min sideband, which breaks the configuration's exact-count
guarantee, and the check must read a gap. Each seed prints one JSON
line with the check's numbers, or with the error a crashed run raised (a
control that crashes has failed as well).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import benchmark  # noqa: E402

benchmark.one_thread_pools()
from benchmark import harness, manifest  # noqa: E402


def control_config(cfg: dict) -> dict:
    """The configuration with too small a dictionary: the largest
    power-of-two capacity at or below the live stacks, so its ids
    (capacity // 2) hold at most half of them."""
    cap = 1 << (int(cfg["unique_stacks"]).bit_length() - 1)
    return dict(cfg, aggregator=dict(cfg["aggregator"], capacity=cap))


def run_control(cfg: dict, mix: dict, seed: int, seconds: float) -> dict:
    cfg = control_config(cfg)
    out = harness.run_cell(cfg, mix, seed, seconds, False)
    check = harness.check_outputs(out, manifest.reference(cfg["reference"]))
    return {"seed": seed,
            "capacity": cfg["aggregator"]["capacity"],
            "windows": check["windows"], "failed": check["failed"],
            "numbers": check["numbers"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    man = manifest.load()
    cell = manifest.cell(man, args.workload)
    cfg = manifest.config(man, cell["config"])
    mix = manifest.traffic(cell["traffic"])
    for seed in (int(s) for s in args.seeds.split(",")):
        try:
            got = run_control(cfg, mix, seed, args.seconds)
        except Exception as e:  # noqa: BLE001 - a crash fails the control
            got = {"seed": seed, "crashed": repr(e)[:500]}
        print(json.dumps(got), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
