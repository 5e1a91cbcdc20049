"""Device-side flight recorder: kernel launch, first-launch and transfer
accounting.

The port's copy of parca_agent_tpu's runtime/device_telemetry.py: a
process-global :class:`DeviceTelemetry` registry that every kernel
dispatch site reports into —

  * per-kernel streaming latency histograms discriminating
    ``event=compile|execute`` via a shape-signature first-call latch.
    In the port "compile" is the FIRST LAUNCH of a signature on a kernel:
    a kernel's very first launch also pays the nvcc build of its source
    (or the load of the cached library), and that cost lands under that
    kernel; later signatures pay only their first-launch costs (scratch
    allocation, a new padded shape);
  * a recompile-storm detector: a NEW signature on a previously-latched
    kernel increments a counter and routes a rate-limited incident
    through the window recorder's incident machinery
    (``FlightRecorder.capture_event``);
  * H2D/D2H transfer-byte accounting per kernel, derived from the
    packed buffer sizes the sites already compute — no extra syncs;
  * a latched identity record: torch and CUDA versions, the device's
    name and count, and each kernel source's route (the hand kernel on
    ``cuda``, its plain PyTorch version on ``cpu``);
  * a window-SLO layer rolling capture-thread busy time plus off-thread
    kernel seconds into a per-window budget-used ratio and a
    windows-over-budget burn counter keyed to the configured period.

The durations are HOST wall clocks around each dispatch: "execute" is the
time the host spent launching (a CUDA launch returns before the kernel
runs), not the kernel's time on the card. Reporting sites
(aggregator/{dict,tpu,sharded}.py) call the module-level hooks
(:func:`record`, :func:`transfer`, :func:`note_backend`,
:func:`tick_window`) — the faults.py pattern: one module-attribute read
when telemetry is off. Several sites sit on the capture path, so every
hook is observation only: wall clocks and byte counts already on the
host, never a device synchronization.

Fail-open like trace.py: every entry point swallows its own errors into
``stats["record_errors"]`` and carries the ``device.telemetry`` chaos
site — telemetry must never cost a window or change a pprof byte.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from parca_agent_tpu_torch.runtime import trace as trace_mod
from parca_agent_tpu_torch.runtime.trace import StageHistogram
from parca_agent_tpu_torch.utils import faults
from parca_agent_tpu_torch.utils.log import get_logger

_log = get_logger("device_telemetry")

# The kernel names the dispatch sites report under (the registry is
# dynamic — these are documentation, not a closed set):
#   feed_probe   dict feed launch, K1 (aggregator/dict.py)
#   miss_settle  vectorized miss plan-then-commit (aggregator/dict.py)
#   close_pack   full close pack launch, B2 (aggregator/dict.py)
#   close_delta  delta close pack launch, B3 (aggregator/dict.py)
#   close_fetch  the packed close D2H collect (aggregator/dict.py)
#   loc_dedup    one-shot window program (aggregator/tpu.py)
#   shard_put    sharded feed upload and launch, B7 (aggregator/sharded.py)
EVENTS = ("compile", "execute")


def _collect_identity(device) -> dict:
    """The latched identity record: torch and CUDA versions, the device,
    and each kernel source's route. Any probe failure degrades a field to
    its unknown default — identity must never cost startup."""
    import socket

    ident = {
        "platform": "unknown",
        "device_kind": "unknown",
        "device_count": 0,
        "torch_version": "unknown",
        "cuda_version": None,
        "routes": {},
        "hostname": socket.gethostname(),
    }
    try:
        import torch

        from parca_agent_tpu_torch.ops.kernels import SIGNATURES

        dev = torch.device(device)
        ident["torch_version"] = str(torch.__version__)
        ident["cuda_version"] = torch.version.cuda
        ident["platform"] = dev.type
        on_card = dev.type == "cuda"
        if on_card:
            ident["device_count"] = torch.cuda.device_count()
            ident["device_kind"] = torch.cuda.get_device_name(
                dev.index or 0)
        else:
            ident["device_kind"] = "cpu"
        ident["routes"] = {name: "cuda" if on_card else "plain"
                           for name in SIGNATURES}
    except Exception:  # noqa: BLE001 - identity is best-effort
        pass
    return ident


class DeviceTelemetry:
    """Process-global device flight recorder (one per agent, installed
    via :func:`install`). Thread-safe; every write path is fail-open."""

    def __init__(self, period_s: float = 0.0, ring: int = 256,
                 incident_interval_s: float = 300.0,
                 clock=time.monotonic, device="cuda"):
        self._lock = threading.Lock()
        self._device = device
        self._clock = clock
        self._t0 = clock()
        self.period_s = float(period_s)
        self._incident_interval = incident_interval_s
        self._hists: dict[tuple[str, str], StageHistogram] = {}  # guarded-by: _lock
        self._shapes: dict[str, set] = {}  # guarded-by: _lock
        self._transfers: dict[tuple[str, str], list[int]] = {}  # guarded-by: _lock
        self._backends: dict[str, dict] = {}  # guarded-by: _lock
        self._identity: dict | None = None  # guarded-by: _lock
        self._budget_hist = StageHistogram()  # guarded-by: _lock
        self._events = deque(maxlen=max(16, ring))  # guarded-by: _lock
        self._windows = deque(maxlen=max(16, ring))  # guarded-by: _lock
        self._win_kernel_s: dict[int, float] = {}  # guarded-by: _lock
        self._last_recompile_at: float | None = None  # guarded-by: _lock
        self.stats = {  # guarded-by: _lock
            "record_errors": 0,
            "events_total": 0,
            "compiles_total": 0,
            "recompiles_total": 0,
            "recompile_incidents": 0,
            "recompile_incidents_suppressed": 0,
        }
        self.window_stats = {  # guarded-by: _lock
            "windows_total": 0,
            "windows_over_budget_total": 0,
            "budget_used_last": 0.0,
        }

    # -- write side (dispatch sites; capture path) ---------------------------

    # palint: fail-open
    def record(self, kernel: str, duration_s: float, shape=None,
               h2d_bytes: int = 0, d2h_bytes: int = 0) -> None:
        """Record one kernel observation: latency histogram keyed
        (kernel, event), shape-signature compile latch, transfer bytes,
        per-window kernel-seconds, and the bounded event timeline.
        ``shape`` is the site's compiled-program signature (its jit
        cache key, or the padded shape class for eager dispatches);
        None records an execute event with no latch. Fail-open."""
        try:
            faults.inject("device.telemetry")
            storm = None
            with self._lock:
                event = "execute"
                if shape is not None:
                    seen = self._shapes.get(kernel)
                    if seen is None:
                        seen = self._shapes[kernel] = set()
                    if shape not in seen:
                        event = "compile"
                        self.stats["compiles_total"] += 1
                        if seen:
                            self.stats["recompiles_total"] += 1
                            storm = (kernel, shape, len(seen) + 1)
                        seen.add(shape)
                self._hists.setdefault(
                    (kernel, event), StageHistogram()).observe(duration_s)
                self.stats["events_total"] += 1
                if h2d_bytes:
                    t = self._transfers.setdefault((kernel, "h2d"), [0, 0])
                    t[0] += int(h2d_bytes)
                    t[1] += 1
                if d2h_bytes:
                    t = self._transfers.setdefault((kernel, "d2h"), [0, 0])
                    t[0] += int(d2h_bytes)
                    t[1] += 1
                tid = threading.get_ident()
                self._win_kernel_s[tid] = \
                    self._win_kernel_s.get(tid, 0.0) + duration_s
                self._events.append({
                    "t_s": round(self._clock() - self._t0, 6),
                    "kernel": kernel,
                    "event": event,
                    "duration_s": round(duration_s, 6),
                    "h2d_bytes": int(h2d_bytes),
                    "d2h_bytes": int(d2h_bytes),
                    "shape": repr(shape) if shape is not None else None,
                })
            if storm is not None:
                self._recompile_incident(*storm)
        except Exception as e:  # noqa: BLE001 - telemetry is fail-open
            self._record_error(e)

    # palint: fail-open
    def record_transfer(self, kernel: str, direction: str,
                        nbytes: int) -> None:
        """Account a transfer with no latency observation (eager device
        writes whose dispatch rides another kernel's clock). Fail-open."""
        try:
            faults.inject("device.telemetry")
            with self._lock:
                t = self._transfers.setdefault((kernel, direction), [0, 0])
                t[0] += int(nbytes)
                t[1] += 1
        except Exception as e:  # noqa: BLE001 - telemetry is fail-open
            self._record_error(e)

    # palint: fail-open
    def note_backend(self, kernel: str, requested: str | None = None,
                     resolved: str | None = None,
                     interpret: bool | None = None,
                     fallback: bool | None = None) -> None:
        """Latch one kernel's backend resolution (requested vs resolved,
        interpret-mode flag, fallback one-hot; the port resolves nothing
        and no site sets a fallback, but the record keeps the original's
        shape). Fields are sticky per call — last write wins, None leaves
        a field alone. Fail-open."""
        try:
            faults.inject("device.telemetry")
            with self._lock:
                rec = self._backends.setdefault(kernel, {
                    "requested": None, "resolved": None,
                    "interpret": None, "fallback": False})
                if requested is not None:
                    rec["requested"] = requested
                if resolved is not None:
                    rec["resolved"] = resolved
                if interpret is not None:
                    rec["interpret"] = bool(interpret)
                if fallback is not None:
                    rec["fallback"] = bool(fallback)
        except Exception as e:  # noqa: BLE001 - telemetry is fail-open
            self._record_error(e)

    # palint: fail-open
    def tick_window(self, used_s: float) -> None:
        """Roll one window into the SLO layer. ``used_s`` is the capture
        thread's busy wall for the window; kernel seconds recorded from
        OTHER threads this window (streaming feed tees, encode-side
        fetches) are added on top — same-thread kernel time is already
        inside ``used_s``. Judged against the configured period; a
        period of 0 (tests, bench micro-phases) counts windows without
        a budget. Fail-open."""
        try:
            faults.inject("device.telemetry")
            with self._lock:
                me = threading.get_ident()
                other = sum(s for tid, s in self._win_kernel_s.items()
                            if tid != me)
                kernel_s = sum(self._win_kernel_s.values())
                self._win_kernel_s.clear()
                used = float(used_s) + other
                self.window_stats["windows_total"] += 1
                entry = {
                    "seq": self.window_stats["windows_total"],
                    "used_s": round(used, 6),
                    "kernel_s": round(kernel_s, 6),
                    "period_s": self.period_s,
                }
                if self.period_s > 0:
                    ratio = used / self.period_s
                    self.window_stats["budget_used_last"] = ratio
                    self._budget_hist.observe(ratio)
                    over = ratio > 1.0
                    if over:
                        self.window_stats["windows_over_budget_total"] += 1
                    entry["ratio"] = round(ratio, 6)
                    entry["over"] = over
                self._windows.append(entry)
        except Exception as e:  # noqa: BLE001 - telemetry is fail-open
            self._record_error(e)

    # palint: fail-open
    def ensure_identity(self) -> dict:
        """Latch (once) and return the identity record. Safe off the
        capture path only — the first call may initialize CUDA.
        Fail-open: an empty dict on error."""
        try:
            with self._lock:
                if self._identity is not None:
                    return dict(self._identity)
            ident = _collect_identity(self._device)
            with self._lock:
                if self._identity is None:
                    self._identity = ident
                return dict(self._identity)
        except Exception as e:  # noqa: BLE001 - telemetry is fail-open
            self._record_error(e)
            return {}

    def _recompile_incident(self, kernel: str, shape, n_shapes: int) -> None:
        """Rate-limited recompile-storm incident routed through the
        window flight recorder's machinery (called inside record()'s
        fail-open guard — its own errors are counted there)."""
        with self._lock:
            now = self._clock()
            if (self._last_recompile_at is not None
                    and now - self._last_recompile_at
                    < self._incident_interval):
                self.stats["recompile_incidents_suppressed"] += 1
                return
            self._last_recompile_at = now
            recompiles = self.stats["recompiles_total"]
        rec = trace_mod.get()
        captured = rec is not None and rec.capture_event(
            "recompile_storm", stage="recompile",
            detail={
                "kernel": kernel,
                "shape": repr(shape),
                "shapes_latched": n_shapes,
                "recompiles_total": recompiles,
                "kernel_percentiles": self.percentiles(),
                "backends": self.backends(),
            })
        with self._lock:
            if captured:
                self.stats["recompile_incidents"] += 1
            else:
                self.stats["recompile_incidents_suppressed"] += 1
        _log.warn("kernel recompile detected", kernel=kernel,
                  shape=repr(shape)[:120], shapes_latched=n_shapes,
                  incident=captured)

    def _record_error(self, e: Exception) -> None:
        try:
            with self._lock:
                self.stats["record_errors"] += 1
            _log.debug("device telemetry recording failed (fail-open)",
                       error=repr(e))
        except Exception:  # noqa: BLE001 - never escalate from here
            pass

    # -- read side (HTTP thread, bench, incident bundles) --------------------

    def export_kernel_histograms(self) -> list[tuple[str, str, dict]]:
        """[(kernel, event, StageHistogram.export())] for /metrics."""
        with self._lock:
            return [(k, e, h.export())
                    for (k, e), h in sorted(self._hists.items())]

    def transfers(self) -> list[tuple[str, str, int, int]]:
        """[(kernel, direction, bytes_total, ops_total)] for /metrics."""
        with self._lock:
            return [(k, d, t[0], t[1])
                    for (k, d), t in sorted(self._transfers.items())]

    def backends(self) -> dict[str, dict]:
        """{kernel: {requested, resolved, interpret, fallback}}."""
        with self._lock:
            return {k: dict(v) for k, v in sorted(self._backends.items())}

    def percentiles(self) -> dict[str, dict]:
        """{kernel: {event: {p50_ms, p99_ms, max_ms, count}}} — the
        compact per-kernel stamp (bench JSON, incident files)."""
        out: dict[str, dict] = {}
        with self._lock:
            for (kernel, event), h in sorted(self._hists.items()):
                out.setdefault(kernel, {})[event] = {
                    "p50_ms": round(h.quantile(0.50) * 1e3, 4),
                    "p99_ms": round(h.quantile(0.99) * 1e3, 4),
                    "max_ms": round(h.max_s * 1e3, 4),
                    "count": h.count,
                }
        return out

    def shape_counts(self) -> dict[str, int]:
        """{kernel: latched shape signatures} (recompiles = count - 1)."""
        with self._lock:
            return {k: len(v) for k, v in sorted(self._shapes.items())}

    def budget_export(self) -> dict:
        """The window-SLO block: ratio histogram + burn counters."""
        with self._lock:
            return {
                "period_s": self.period_s,
                "hist": self._budget_hist.export(),
                **dict(self.window_stats),
            }

    def snapshot(self) -> dict:
        """The full JSON-able telemetry stamp (bench artifacts,
        /debug/device): identity, per-kernel events/percentiles/shape
        latches, backends, transfers, window budget, self-accounting."""
        ident = self.ensure_identity()
        shapes = self.shape_counts()
        kernels: dict[str, dict] = {}
        for kernel, events in self.percentiles().items():
            kernels[kernel] = {
                "events": events,
                "compiles": events.get("compile", {}).get("count", 0),
                "executes": events.get("execute", {}).get("count", 0),
                "shapes_latched": shapes.get(kernel, 0),
                "recompiles": max(0, shapes.get(kernel, 0) - 1),
            }
        transfers: dict[str, dict] = {}
        for kernel, direction, nbytes, ops in self.transfers():
            transfers.setdefault(kernel, {})[direction] = {
                "bytes": nbytes, "ops": ops}
        with self._lock:
            stats = dict(self.stats)
        return {
            "identity": ident,
            "kernels": kernels,
            "backends": self.backends(),
            "transfers": transfers,
            "window_budget": self.budget_export(),
            "stats": stats,
        }

    def timeline(self, limit: int | None = None) -> dict:
        """The bounded rings for /debug/device: recent kernel events and
        per-window SLO entries, oldest first."""
        with self._lock:
            events = list(self._events)
            windows = list(self._windows)
        if limit:
            events = events[-limit:]
            windows = windows[-limit:]
        return {"events": events, "windows": windows}


# -- process-global installation (the faults.py pattern) ----------------------

_active: DeviceTelemetry | None = None


def install(telemetry: DeviceTelemetry | None) -> None:
    """Install (or with None, remove) the process-wide device telemetry.
    The CLI calls this once at startup; tests install/uninstall around
    cases."""
    global _active
    _active = telemetry


def get() -> DeviceTelemetry | None:
    return _active


def record(kernel: str, duration_s: float, shape=None,
           h2d_bytes: int = 0, d2h_bytes: int = 0) -> None:
    """Dispatch-site hook: free when no telemetry is installed."""
    if _active is not None:
        _active.record(kernel, duration_s, shape, h2d_bytes, d2h_bytes)


def transfer(kernel: str, direction: str, nbytes: int) -> None:
    """Transfer-only site hook (eager device writes)."""
    if _active is not None:
        _active.record_transfer(kernel, direction, nbytes)


def note_backend(kernel: str, **fields) -> None:
    """Backend-resolution latch hook."""
    if _active is not None:
        _active.note_backend(kernel, **fields)


def tick_window(used_s: float) -> None:
    """Window-SLO hook, called once per profiler iteration."""
    if _active is not None:
        _active.tick_window(used_s)
