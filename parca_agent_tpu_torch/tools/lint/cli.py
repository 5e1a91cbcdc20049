"""palint CLI: run the checkers, apply the baseline, gate on growth.

Exit codes: 0 clean (everything found is baselined or suppressed),
1 non-baselined findings, 2 usage errors. ``--json`` emits one machine-
readable object on stdout for CI/bench consumption; the human format is
``file:line:col: [checker-id] message (symbol)``.

Stale baseline entries (fixed findings still listed in baseline.json)
are always REPORTED — the baseline must shrink with the fixes, not
fossilize — but do not fail the run: use ``--write-baseline`` to
refresh it after fixing, then commit the smaller file.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from parca_agent_tpu_torch.tools.lint.bounded_call_check import (
    BoundedCallChecker,
)
from parca_agent_tpu_torch.tools.lint.chaos_sites import ChaosSiteChecker
from parca_agent_tpu_torch.tools.lint.core import (
    Project,
    apply_baseline,
    load_baseline,
    run_checkers,
    write_baseline,
)
from parca_agent_tpu_torch.tools.lint.crash_only_io import CrashOnlyIOChecker
from parca_agent_tpu_torch.tools.lint.fail_open import FailOpenChecker
from parca_agent_tpu_torch.tools.lint.host_sync import HostSyncChecker
from parca_agent_tpu_torch.tools.lint.lock_discipline import (
    LockDisciplineChecker,
)

ALL_CHECKERS = (
    LockDisciplineChecker,
    FailOpenChecker,
    CrashOnlyIOChecker,
    ChaosSiteChecker,
    HostSyncChecker,
    BoundedCallChecker,
)

CHECKER_IDS = tuple(c.id for c in ALL_CHECKERS)

_DEFAULT_BASELINE = os.path.join(os.path.dirname(__file__),
                                 "baseline.json")


def build_checkers(only: list[str] | None = None):
    ids = set(only) if only else None
    out = []
    for cls in ALL_CHECKERS:
        if ids is None or cls.id in ids:
            out.append(cls())
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="palint",
        description="AST-based invariant checker for the agent's "
                    "concurrency, fail-open, and crash-only contracts "
                    "(docs/static-analysis.md), over the port")
    ap.add_argument("--root", default=".",
                    help="repository root (default: cwd)")
    ap.add_argument("--package", default="parca_agent_tpu_torch",
                    help="package directory under root to lint")
    ap.add_argument("--tests", default="tests",
                    help="test directory under root (chaos-site "
                         "coverage only, from the port's test modules; "
                         "tests are never linted)")
    ap.add_argument("--checker", action="append", choices=CHECKER_IDS,
                    help="run only this checker (repeatable)")
    ap.add_argument("--baseline", default=_DEFAULT_BASELINE,
                    help="baseline file (default: tools/lint/"
                         "baseline.json)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report everything, ignore the baseline")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite the baseline from the current "
                         "findings and exit 0")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable JSON on stdout")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    project = Project.load(args.root, package=args.package,
                           tests=args.tests)
    if not project.files:
        print(f"palint: nothing to lint under "
              f"{os.path.join(args.root, args.package)}", file=sys.stderr)
        return 2
    checkers = build_checkers(args.checker)
    active_ids = {c.id for c in checkers}
    findings, suppressed = run_checkers(project, checkers)

    if args.write_baseline:
        keep = []
        if args.checker and os.path.exists(args.baseline):
            # Partial run: entries belonging to checkers that did NOT
            # run are preserved verbatim, not silently deleted.
            try:
                with open(args.baseline, encoding="utf-8") as fp:
                    keep = [e for e in json.load(fp).get("findings", [])
                            if isinstance(e, dict)
                            and e.get("checker") not in active_ids]
            except (ValueError, OSError) as e:
                print(f"palint: bad baseline {args.baseline}: {e}",
                      file=sys.stderr)
                return 2
        write_baseline(args.baseline, findings, keep=keep)
        print(f"palint: wrote {len(findings)} finding(s) "
              f"(+{len(keep)} preserved) to {args.baseline}",
              file=sys.stderr)
        return 0

    baseline = {}
    if not args.no_baseline and os.path.exists(args.baseline):
        try:
            baseline = load_baseline(args.baseline)
        except (ValueError, KeyError, TypeError, OSError) as e:
            print(f"palint: bad baseline {args.baseline}: {e}",
                  file=sys.stderr)
            return 2
        # A --checker run only sees that checker's findings; the other
        # checkers' baseline entries are neither spendable nor stale.
        baseline = {k: n for k, n in baseline.items()
                    if k.split("::", 1)[0] in active_ids}
    new, baselined, stale = apply_baseline(findings, baseline)

    dur_s = time.perf_counter() - t0
    if args.as_json:
        print(json.dumps({
            "findings": [f.to_dict() for f in new],
            "baselined": baselined,
            "suppressed": suppressed,
            "stale_baseline": stale,
            "files": len(project.files),
            "checkers": [c.id for c in checkers],
            "duration_s": round(dur_s, 3),
        }, indent=2, sort_keys=True))
    else:
        for f in new:
            print(f.render())
        for key in stale:
            print(f"palint: stale baseline entry (fix landed — remove "
                  f"it): {key}", file=sys.stderr)
        print(f"palint: {len(new)} finding(s), {baselined} baselined, "
              f"{suppressed} suppressed, {len(stale)} stale baseline "
              f"entr{'y' if len(stale) == 1 else 'ies'}, "
              f"{len(project.files)} files in {dur_s:.2f}s",
              file=sys.stderr)
    return 1 if new else 0


if __name__ == "__main__":  # pragma: no cover - __main__.py is the entry
    sys.exit(main())
