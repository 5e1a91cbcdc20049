"""Deterministic fault injection for the ship path.

The port's copy of parca_agent_tpu's utils/faults.py, whole. The port
injects ``maps.parse``, ``elf.read``, ``perfmap.parse``,
``process.identity``, ``symbolize.kernel``, ``unwind.build``,
``feed.coalesce``, ``feed.carry``, ``statics.snapshot``,
``trace.record``, ``incident.dump``, ``device.telemetry``,
``device.probe``, ``device.dispatch``, ``fleet.join``,
``fleet.collective``, the ship path's ``grpc.write_raw``,
``grpc.handshake``, ``spool.write``, ``batch.flush`` and
``writer.write``, the actor sites ``actor.profiler``,
``actor.encode``, ``actor.feeder`` and ``actor.flush``, and the workload
zoo's ``zoo.scenario``, ``zoo.path`` and ``soak.tick``; the registry
below names every site of the original, as the chaos suite's contract.

The always-on agent's hard scenarios — hours-long store outages, cert
rotations, disk-full spool directories, partial actor death — cannot be
waited for; they have to be injected. This module is the single chaos
layer the ship-path components consult at NAMED SITES:

    grpc.write_raw    the WriteRaw RPC (unavailable / handshake / latency)
    grpc.handshake    channel construction (TLS handshake class)
    spool.write       spill-segment write (disk_full)
    writer.write      local-store profile write (disk_full)
    batch.flush       one flush attempt of the batch client
    actor.<name>      a supervised actor's loop tick (crash)
    statics.snapshot  warm statics+registry snapshot write
                      (pprof/statics_store.py; disk_full/error — a
                      failed snapshot is counted and skipped, the
                      window it followed is already shipped)
    trace.record      every flight-recorder entry point (runtime/
                      trace.py begin/add_span/complete/observe) — the
                      tracing path is FAIL-OPEN by contract: an injected
                      fault here is swallowed and counted
                      (record_errors) and must never stall or lose a
                      window (docs/observability.md)
    incident.dump     the slow-window incident writer — an injected
                      fault costs the incident file (incidents_failed),
                      never the window
    hotspot.fold      one window's fold into the hotspot rollup store
                      (runtime/hotspots.py) — fail-open like tracing:
                      an injected fault is counted (fold_errors) and
                      costs query freshness, never the window
    sink.emit         one secondary output-backend's per-window emit
                      (sinks/registry.py) — fail-open by contract: an
                      injected fault is counted (the sink's errors
                      stat) and costs that sink one window, never the
                      pprof ship (docs/sinks.md)
    sink.flush        one AutoFDO profdata file's crash-only rewrite
                      (sinks/autofdo.py; disk_full/error — counted
                      flush_errors, the file stays dirty and is
                      retried at the next flush cadence)
    admission.resolve one pid's cgroup -> tenant resolution
                      (runtime/admission.py) — fail-open by contract:
                      an injected fault is counted (resolve_errors)
                      and lands the pid in the "unknown" tenant,
                      never costing a window
    admission.shed    one overload-governor shed step
                      (runtime/admission.py) — fail-open: an injected
                      fault is counted (shed_errors) and costs this
                      window's shed step only; quotas and windows are
                      untouched
    regression.fold   one window's fold into the regression sentinel's
                      rollup groups (runtime/regression.py) — fail-open
                      like the hotspot fold: an injected fault is
                      counted (fold_errors) and costs that window's
                      judgment, never the window or the pprof ship
    regression.baseline
                      the sentinel's baseline persistence (save on the
                      encode worker, adopt at startup) — counted
                      (baseline_save_errors / baseline_adopt_errors)
                      and skipped: the sentinel relearns cold, the
                      agent is unharmed
    feed.coalesce     the host-side (stack, weight) fold of one feed
                      batch (aggregator/dict.py; docs/perf.md "ingest
                      wall") — fail-open by contract: an injected fault
                      is counted (coalesce_fallbacks) and the batch
                      dispatches UNCOALESCED — identical counts and
                      pprof bytes, never a lost feed or window
    feed.carry        the cross-drain carry-cache match of one feed
                      batch (aggregator/dict.py; docs/perf.md "feed
                      endgame") — fail-open by contract: an injected
                      fault is counted (carry_fallbacks) and the
                      aggregator falls back to per-drain dispatch for
                      the REST of the window (mass already carried
                      still flushes at close) — identical counts and
                      pprof bytes, never a lost feed or window
    device.telemetry  every device flight-recorder entry point
                      (runtime/device_telemetry.py record /
                      record_transfer / note_backend / tick_window) —
                      fail-open like trace.record: an injected fault is
                      swallowed and counted (record_errors) and must
                      never cost a window or change a pprof byte
                      (docs/observability.md "device flight recorder")

and, on the ingest side (docs/robustness.md "ingest containment" — the
``poison`` kind raises an InjectedPoison, which IS a PoisonInput, so an
injected fault rides the same per-pid attribution path as real poison):

    elf.read          ElfFile construction over untrusted bytes
    perfmap.parse     reading + parsing a JIT perf map
    maps.parse        parsing /proc/<pid>/maps
    symbolize.kernel  the batched kallsyms resolve
    unwind.build      building one mapping's unwind table

and, on the device-runtime side (docs/robustness.md "device & fleet
health" — the ``hang`` kind is duration-bearing: the site sleeps ``ms``
milliseconds, default one hour, modeling a wedged C call that no
exception ever leaves; the caller's watchdog/deadline machinery is what
must bound it):

    device.probe      one backend bring-up probe (runtime/device_health.py)
    device.dispatch   the guarded device aggregation call (profiler/cpu.py)
    fleet.join        jax.distributed fleet join (parallel/distributed.py)
    fleet.collective  one fleet merge/re-probe collective round

Sites call :func:`inject` which is a no-op until an injector is installed
(via the CLI's --fault-inject flag, the PARCA_FAULTS env var, or a test):
production pays one module-attribute read per site.

Determinism: every probabilistic draw comes from one seeded
``random.Random`` and every time window from one injectable clock, so a
fixed seed + deterministic call order reproduces the same fault schedule
— the chaos suite and the bench soak phase both rely on this.

Rule spec grammar (CLI/env), semicolon-separated::

    site:kind[:k=v[,k=v...]]

    kinds:  unavailable | handshake | error | latency | disk_full | crash
            | poison | hang
    keys:   p=<prob 0..1>   firing probability (default 1)
            after=<s>       rule arms this many seconds after install
            for=<s>         rule disarms this many seconds after arming
            count=<n>       max total firings
            ms=<millis>     latency/hang kinds: injected delay (hang
                            defaults to 3600000 — "forever" at any
                            realistic watchdog deadline)

Example — a scripted 60 s store outage five seconds in, plus a flaky
spool disk::

    grpc.write_raw:unavailable:after=5,for=60;spool.write:disk_full:p=0.2
"""

from __future__ import annotations

import dataclasses
import errno
import random
import threading
import time

from parca_agent_tpu_torch.utils.log import get_logger
from parca_agent_tpu_torch.utils.poison import PoisonInput

_log = get_logger("faults")


# The machine-readable site registry: the contract between the inject()
# call sites, the chaos-marked tests, and palint's chaos-site checker
# (tools/lint/chaos_sites.py), which enforces that the three agree —
# every call site documented here, every entry injected somewhere, and
# every entry exercised by at least one test under the `chaos` marker.
# The docstring above narrates the same list; THIS is the source of
# truth a checker can read. Wildcard entries ("actor.*") match by
# prefix, mirroring FaultRule.matches.
SITES = {
    "grpc.write_raw": "the WriteRaw RPC (agent/grpc_client.py)",
    "grpc.handshake": "channel construction (agent/grpc_client.py)",
    "spool.write": "spill-segment write (agent/spool.py)",
    "writer.write": "local-store profile write (agent/writer.py)",
    "batch.flush": "one flush attempt (agent/batch.py)",
    "actor.*": "a supervised actor's loop tick (runtime/supervisor.py)",
    "statics.snapshot": "warm statics snapshot (pprof/statics_store.py)",
    "trace.record": "flight-recorder entry points (runtime/trace.py)",
    "incident.dump": "slow-window incident writer (runtime/trace.py)",
    "hotspot.fold": "hotspot rollup fold (runtime/hotspots.py)",
    "sink.emit": "secondary output-backend emit (sinks/registry.py)",
    "sink.flush": "AutoFDO profdata crash-only rewrite (sinks/autofdo.py)",
    "admission.resolve": "pid -> tenant resolution (runtime/admission.py)",
    "admission.shed": "overload-governor shed step (runtime/admission.py)",
    "regression.fold": "regression sentinel fold (runtime/regression.py)",
    "regression.baseline":
        "sentinel baseline save/adopt (runtime/regression.py)",
    "feed.coalesce": "feed-batch (stack, weight) fold (aggregator/dict.py)",
    "feed.carry": "cross-drain carry-cache match (aggregator/dict.py)",
    "elf.read": "ElfFile construction (elf/reader.py)",
    "perfmap.parse": "JIT perf-map read+parse (symbolize/perfmap.py)",
    "maps.parse": "/proc/<pid>/maps parse (process/maps.py)",
    "symbolize.kernel": "batched kallsyms resolve (symbolize/ksym.py)",
    "unwind.build": "one mapping's unwind table (unwind/table.py)",
    "device.probe": "backend bring-up probe (runtime/device_health.py)",
    "device.dispatch": "guarded device aggregation (profiler/cpu.py)",
    "fleet.join": "jax.distributed fleet join (parallel/distributed.py)",
    "fleet.collective": "one fleet merge/re-probe collective round",
    "device.telemetry":
        "device flight-recorder entry points (runtime/device_telemetry.py)",
    "process.identity":
        "per-window pid generation check (process/identity.py)",
    "zoo.scenario":
        "one zoo scenario window build (bench_zoo/scenarios.py)",
    "zoo.path":
        "one zoo streaming-arm feed step (bench_zoo/runner.py) — "
        "fail-open: an injected fault is counted (path_fallbacks) and "
        "the window ships via the one-shot close path instead, same "
        "mass, never a lost window",
    "soak.tick":
        "one soak-loop accounting sample (bench_zoo/soak.py) — "
        "fail-open: an injected fault is counted (tick_errors) and "
        "costs that window's RSS/byte sample only, never the window "
        "or the verdict arithmetic",
}


class InjectedFault(Exception):
    """Base class for every injected failure (tests filter on it)."""


class InjectedPoison(InjectedFault, PoisonInput):
    """An injected malformed-input fault: both an InjectedFault (the
    chaos suite filters on it) and a PoisonInput (the ingest containment
    layer attributes it to a pid like real poison)."""

    def __init__(self, site: str):
        self.site = site
        super().__init__(f"injected poison input at {site}")


class InjectedCrash(InjectedFault):
    """An actor-crash fault: escapes the actor's loop so the supervisor
    sees a real thread death."""


class InjectedRpcError(InjectedFault):
    """Mimics a grpc RpcError closely enough for GRPCStoreClient's
    failure classifier: code() returns the real StatusCode.UNAVAILABLE
    when grpc is importable, and the detail string carries the handshake
    markers for handshake-class rules."""

    def __init__(self, kind: str, site: str):
        self.kind = kind
        detail = (f"injected fault at {site}: Ssl handshake failed"
                  if kind == "handshake"
                  else f"injected fault at {site}: connection refused")
        super().__init__(detail)
        self._detail = detail

    def code(self):
        try:
            import grpc

            return grpc.StatusCode.UNAVAILABLE
        except ImportError:  # pragma: no cover - grpc is in the image
            return "UNAVAILABLE"

    def details(self) -> str:
        return self._detail

    def debug_error_string(self) -> str:
        return self._detail


def injected_disk_full(site: str) -> OSError:
    return OSError(errno.ENOSPC,
                   f"injected fault at {site}: no space left on device")


@dataclasses.dataclass
class FaultRule:
    site: str              # exact name, or prefix wildcard "actor.*"
    kind: str              # unavailable|handshake|error|latency|disk_full|crash
    p: float = 1.0
    after_s: float = 0.0
    for_s: float | None = None
    count: int | None = None
    latency_s: float = 0.0
    fired: int = 0

    def matches(self, site: str) -> bool:
        if self.site.endswith("*"):
            return site.startswith(self.site[:-1])
        return site == self.site


_KINDS = ("unavailable", "handshake", "error", "latency", "disk_full",
          "crash", "poison", "hang")

# A hang with no explicit ms= is "forever" relative to any watchdog.
_HANG_DEFAULT_S = 3600.0


def parse_rules(spec: str) -> list[FaultRule]:
    rules = []
    for part in filter(None, (s.strip() for s in spec.split(";"))):
        fields = part.split(":", 2)
        if len(fields) < 2:
            raise ValueError(f"bad fault rule {part!r} (want site:kind)")
        site, kind = fields[0], fields[1]
        if kind not in _KINDS:
            raise ValueError(f"unknown fault kind {kind!r} "
                             f"(want one of {_KINDS})")
        rule = FaultRule(site=site, kind=kind)
        for kv in filter(None, (fields[2].split(",")
                                if len(fields) == 3 else ())):
            k, _, v = kv.partition("=")
            if k == "p":
                rule.p = float(v)
            elif k == "after":
                rule.after_s = float(v)
            elif k == "for":
                rule.for_s = float(v)
            elif k == "count":
                rule.count = int(v)
            elif k == "ms":
                rule.latency_s = float(v) / 1e3
            else:
                raise ValueError(f"unknown fault rule key {k!r} in {part!r}")
        if rule.kind == "hang" and rule.latency_s == 0.0:
            rule.latency_s = _HANG_DEFAULT_S
        rules.append(rule)
    return rules


class FaultInjector:
    def __init__(self, rules: list[FaultRule], seed: int = 0,
                 clock=time.monotonic, sleep=time.sleep):
        self._rules = list(rules)
        self._rng = random.Random(seed)
        self._clock = clock
        self._sleep = sleep
        self._t0 = clock()
        self._lock = threading.Lock()
        self.fired: dict[str, int] = {}

    @classmethod
    def from_spec(cls, spec: str, seed: int = 0, clock=time.monotonic,
                  sleep=time.sleep) -> "FaultInjector":
        return cls(parse_rules(spec), seed=seed, clock=clock, sleep=sleep)

    def _armed(self, rule: FaultRule, now_s: float) -> bool:
        if now_s < rule.after_s:
            return False
        if rule.for_s is not None and now_s >= rule.after_s + rule.for_s:
            return False
        if rule.count is not None and rule.fired >= rule.count:
            return False
        return True

    def check(self, site: str) -> None:
        """Apply every matching armed rule: latency/hang rules sleep,
        error rules raise (first match wins for raises). Thread-safe;
        draws are serialized so a fixed seed stays reproducible."""
        delay = 0.0
        raise_rule: FaultRule | None = None
        with self._lock:
            now_s = self._clock() - self._t0
            for rule in self._rules:
                if not rule.matches(site) or not self._armed(rule, now_s):
                    continue
                if rule.p < 1.0 and self._rng.random() >= rule.p:
                    continue
                rule.fired += 1
                self.fired[site] = self.fired.get(site, 0) + 1
                if rule.kind in ("latency", "hang"):
                    delay += rule.latency_s
                elif raise_rule is None:
                    raise_rule = rule
        if delay:
            self._sleep(delay)
        if raise_rule is None:
            return
        kind = raise_rule.kind
        _log.debug("injecting fault", site=site, kind=kind)
        if kind in ("unavailable", "handshake"):
            raise InjectedRpcError(kind, site)
        if kind == "disk_full":
            raise injected_disk_full(site)
        if kind == "crash":
            raise InjectedCrash(f"injected crash at {site}")
        if kind == "poison":
            raise InjectedPoison(site)
        raise InjectedFault(f"injected fault at {site}")

    def stats(self) -> dict[str, int]:
        with self._lock:
            return dict(self.fired)


# -- process-global installation ---------------------------------------------

_active: FaultInjector | None = None


def install(injector: FaultInjector | None) -> None:
    """Install (or with None, remove) the process-wide injector. The CLI
    calls this once at startup; tests install/uninstall around cases."""
    global _active
    _active = injector


def get() -> FaultInjector | None:
    return _active


def inject(site: str) -> None:
    """The site hook: free when no injector is installed."""
    if _active is not None:
        _active.check(site)
