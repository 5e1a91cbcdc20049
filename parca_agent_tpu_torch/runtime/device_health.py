"""Device health: a bounded bring-up probe and the card's fault record.

The port's subset of parca_agent_tpu's runtime/device_health.py. The
failure it exists for is a wedged device runtime that blocks INSIDE a C
call (context creation, a launch, a fetch): no exception ever leaves it
and no thread can cancel it. So:

  * the bring-up probe runs in a THROWAWAY SUBPROCESS with a hard
    deadline and a kill (:func:`subprocess_probe`): the child imports
    torch, initializes CUDA and launches one of the port's own hand
    kernels (the row hash on a few rows), so a wedged init or a broken
    kernel build costs one dead child, never a hung agent. The CLI runs
    it before its own process touches the card, and stops when it fails;
  * the profiler's device watchdog (profiler/cpu.py) reports each
    guarded call's outcome here: errors are counted, a hang wedges the
    registry for good.

The original's registry is a state machine that DEMOTES the agent to a
CPU fallback aggregator on a failed probe, a hang or repeated errors,
re-probes after a cooldown and promotes back through a shadow window in
which both backends aggregate and must agree. The port has nothing to
demote to — no aggregation runs on the CPU when the card is asked for —
so none of that is here: the states are ``probing`` -> ``healthy`` on a
good probe, ``failed`` on a failed or hung one, and ``wedged`` after a
dispatch hang, which ends the run (the CLI flushes the trace and this
snapshot, then exits non-zero). Dispatch errors are counted and
propagate; they do not change the state.

Chaos site: ``device.probe`` fires inside the bounded probe call, before
the probe runs (a ``hang`` rule there models a spawn that never
returns); ``device.dispatch`` is the profiler's.
"""

from __future__ import annotations

import subprocess
import sys
import threading
import time

from parca_agent_tpu_torch.utils import faults
from parca_agent_tpu_torch.utils.bounded import bounded_call
from parca_agent_tpu_torch.utils.log import get_logger

_log = get_logger("device-health")

STATE_PROBING = "probing"
STATE_HEALTHY = "healthy"
STATE_FAILED = "failed"
STATE_WEDGED = "wedged"
# Every state, in order: the one-hot of /metrics' parca_agent_device_state.
STATES = (STATE_PROBING, STATE_HEALTHY, STATE_FAILED, STATE_WEDGED)

# One small round trip through a hand kernel: CUDA init, the row hash's
# build (or its cached library's load), one launch over 8 rows, a fetch.
# Printing "1" proves the whole path, not just that the import survived.
# On a CPU device the wrapper runs its plain version (the tests' case).
_PROBE_CODE = (
    "import sys, torch\n"
    "sys.path.insert(0, {root!r})\n"
    "from parca_agent_tpu_torch.ops.row_hash import row_hash, "
    "row_hash_plain\n"
    "from parca_agent_tpu_torch.utils.device import resolve_device\n"
    "dev = resolve_device({device!r})\n"
    "n, s = 8, 4\n"
    "g = torch.Generator().manual_seed(1)\n"
    "lanes = [torch.randint(-2**31, 2**31, (n, s), generator=g, "
    "dtype=torch.int64).to(torch.int32) for _ in range(2)]\n"
    "ints = [torch.full((n,), v, dtype=torch.int32) for v in (7, s, 0)]\n"
    "got = row_hash(*[t.to(dev) for t in lanes + ints])\n"
    "want = row_hash_plain(*lanes, *ints)\n"
    "print(int(all(torch.equal(a.cpu(), b) for a, b in zip(got, want))))\n"
)


def probe_code(device: str = "cuda") -> str:
    """The probe child's program for ``device``."""
    from pathlib import Path

    root = str(Path(__file__).resolve().parent.parent.parent)
    return _PROBE_CODE.format(root=root, device=str(device))


def subprocess_probe(timeout_s: float, device: str = "cuda",
                     code: str | None = None) -> tuple[bool, str]:
    """One bring-up probe in a throwaway subprocess, killed at
    ``timeout_s``. A wedged device init cannot be cancelled from a thread
    (it hangs inside a C call), but a child process CAN be killed — this
    is the only hang-proof shape for the probe. Returns (ok, detail)."""
    try:
        r = subprocess.run([sys.executable, "-c",
                            code if code is not None else probe_code(device)],
                           capture_output=True, text=True,
                           timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return False, f"probe hung >{timeout_s:.0f}s (child killed)"
    except OSError as e:  # pragma: no cover - spawn failure is exotic
        return False, f"probe spawn failed: {e!r}"
    if r.returncode != 0:
        tail = (r.stderr or "").strip().splitlines()
        last = tail[-1][-200:] if tail else "no output"
        return False, f"probe rc={r.returncode}: {last}"
    if (r.stdout or "").strip().splitlines()[-1:] != ["1"]:
        return False, f"probe wrong output: {(r.stdout or '')[:80]!r}"
    return True, "ok"


class DeviceHealthRegistry:
    """The card's fault record (module docs above).

    ``probe`` is a zero-arg callable returning ``(ok, detail)`` — the CLI
    passes :func:`subprocess_probe`; ``None`` trusts the card at once
    (the first guarded dispatch is itself watchdogged). A probe that
    outlives ``probe_deadline_s`` (the probe's own timeout plus a grace,
    for probes wedged before their own bound can fire) is a hang.

    All mutation is lock-protected: the profiler thread reports faults
    and ticks windows, the CLI reads snapshots."""

    def __init__(self, probe=None, probe_timeout_s: float = 60.0,
                 probe_deadline_s: float | None = None,
                 clock=time.monotonic):
        self._probe = probe
        self._probe_deadline = (probe_deadline_s
                                if probe_deadline_s is not None
                                else probe_timeout_s + 5.0)
        self._clock = clock
        self._lock = threading.Lock()
        self.state = STATE_PROBING if probe is not None \
            else STATE_HEALTHY  # guarded-by: _lock
        self.windows = 0                    # guarded-by: _lock
        self.wedged_at: int | None = None   # window of the hang
        self.last_error: str = ""
        self.last_probe_s: float | None = None
        self.stats = {  # guarded-by: _lock
            "probes_total": 0,
            "probes_ok": 0,
            "probes_failed": 0,   # == probes_total - probes_ok (invariant)
            "probes_hung": 0,     # the probes_failed that were deadline
            #                       overruns
            "hangs_total": 0,
            "dispatch_errors_total": 0,
        }

    # -- bring-up ------------------------------------------------------------

    def run_probe(self) -> bool:
        """Run the probe once, bounded by its deadline, on this thread's
        watch (the probe itself runs on an abandonable helper thread).
        Returns whether the card proved out; the state follows."""
        with self._lock:
            if self._probe is None:
                return self.state == STATE_HEALTHY
            self.stats["probes_total"] += 1

        def call():
            faults.inject("device.probe")
            return self._probe()

        t0 = self._clock()
        status, out, _done, _box = bounded_call(
            call, self._probe_deadline, thread_name="device-probe")
        with self._lock:
            self.last_probe_s = self._clock() - t0
            if status == "ok" and bool(out[0]):
                self.stats["probes_ok"] += 1
                self.state = STATE_HEALTHY
                _log.info("device probe ok", detail=str(out[1]),
                          probe_s=round(self.last_probe_s, 3))
                return True
            self.stats["probes_failed"] += 1
            if status == "hang":
                self.stats["probes_hung"] += 1
                detail = (f"probe overran its deadline "
                          f"({self._probe_deadline:.0f}s)")
            elif status == "err":
                detail = repr(out)
            else:
                detail = str(out[1])
            self.last_error = detail[:200]
            self.state = STATE_FAILED
        _log.error("device probe failed", error=self.last_error)
        return False

    # -- the profiler's guarded device calls ---------------------------------

    def record_dispatch_error(self, exc: BaseException) -> None:
        """A guarded device call that raised: counted; the error itself
        propagates to the caller."""
        with self._lock:
            self.stats["dispatch_errors_total"] += 1
            self.last_error = repr(exc)[:200]

    def record_hang(self) -> None:
        """A guarded device call blew its watchdog and was abandoned. The
        card is wedged for good: the run ends."""
        with self._lock:
            self.stats["hangs_total"] += 1
            self.wedged_at = window = self.windows
            self.last_error = "device call hung (abandoned)"
            self.state = STATE_WEDGED
        _log.error("device call hung; the card is wedged", window=window)

    def tick_window(self) -> None:
        """One window passed (the profiler calls this once an iteration)."""
        with self._lock:
            self.windows += 1

    # -- observability -------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-shaped view (the CLI's exit line, incident files)."""
        with self._lock:
            return {
                "state": self.state,
                "windows": self.windows,
                "wedged_at_window": self.wedged_at,
                "last_error": self.last_error,
                "last_probe_s": self.last_probe_s,
                "stats": dict(self.stats),
            }
