"""Inspect a saved window snapshot (the replayable map-dump format,
SURVEY.md §4 / BASELINE config #2).

The port's copy of parca_agent_tpu/tools/snapshot.py (the same text for
the same file). Dev tool in the spirit of the reference's cmd/eh-frame:
makes the capture artifact a thing you can look at. Prints window stats
(incl. depth min/median/max), per-pid totals, and the top stacks by
count.

Run: python -m parca_agent_tpu_torch.tools.snapshot FILE [--top N] [--pids N]
"""

from __future__ import annotations

import argparse

import numpy as np

from parca_agent_tpu_torch.capture.formats import WindowSnapshot, load_snapshot


def format_summary(snap: WindowSnapshot, top: int = 10,
                   pids: int = 10) -> str:
    n = len(snap)
    total = int(snap.counts.sum())
    uniq_pids = np.unique(snap.pids)
    depth = snap.user_len.astype(np.int64) + snap.kernel_len.astype(np.int64)
    lines = [
        f"rows: {n}",
        f"samples: {total}",
        f"pids: {len(uniq_pids)}",
        f"period_ns: {snap.period_ns}  window_ns: {snap.window_ns}",
        f"depth: min {int(depth.min()) if n else 0} "
        f"median {int(np.median(depth)) if n else 0} "
        f"max {int(depth.max()) if n else 0}",
        f"kernel frames: {int(snap.kernel_len.sum())} "
        f"user frames: {int(snap.user_len.sum())}",
        f"mappings: {len(snap.mappings.starts)} rows, "
        f"{len(snap.mappings.obj_paths)} objects",
    ]
    if n:
        upids, inv = np.unique(snap.pids, return_inverse=True)
        pid_totals = np.bincount(inv, weights=snap.counts.astype(np.float64))
        lines.append(f"top pids by samples (of {len(upids)}):")
        for j in np.argsort(-pid_totals)[:pids].tolist():
            lines.append(
                f"  pid {int(upids[j]):>7}  {int(pid_totals[j]):>10} samples")
        order = np.argsort(-snap.counts)[:top]
        lines.append("top stacks by count:")
        for i in order.tolist():
            d = int(depth[i])  # user frames then kernel frames
            frames = " ".join(f"{a:#x}" for a in snap.stacks[i, :min(d, 4)])
            more = f" …(+{d - 4})" if d > 4 else ""
            lines.append(
                f"  pid {int(snap.pids[i]):>7} x{int(snap.counts[i]):<8} "
                f"{frames}{more}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="print stats for a saved window snapshot")
    ap.add_argument("file")
    ap.add_argument("--top", type=int, default=10,
                    help="top stacks to list")
    ap.add_argument("--pids", type=int, default=10,
                    help="top pids to list")
    args = ap.parse_args(argv)
    snap = load_snapshot(args.file)
    print(format_summary(snap, top=args.top, pids=args.pids))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
