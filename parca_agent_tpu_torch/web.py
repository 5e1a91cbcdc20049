"""HTTP surface: status page, metrics, live query, health, debug.

The port's copy of parca_agent_tpu's web.py (the reference's mux in
cmd/parca-agent/main.go:269-503 and its status template): `/` renders
the window loop and each written pid's state with query links;
`/metrics` serves strict Prometheus text exposition; `/query` returns
the next matching raw profile (the MatchingProfileListener); `/healthy`
is the liveness probe and `/healthz` the supervised readiness probe
(per-actor healthy/degraded/dead from the run group); `/debug/windows`,
`/debug/trace/<seq>` and `/debug/device` serve the flight recorders, and
`/debug/pprof/*` profiles the agent itself (profiler/selfprofile.py).
Built on http.server (stdlib).

`render_metrics` reads the port's own components: the window loops of
profiler/cpu.py (their metrics, ``aggregator``, ``pipeline``,
``encoder``, ``feeder``, ``symbolizer`` and ``duration_s``), the batch
client, the supervisor, the quarantine and device-health registries,
the statics store, the flight recorder, device telemetry, the process
identity and the analytics: the hotspot rollups (runtime/hotspots.py),
the admission controller (runtime/admission.py), the regression
sentinel (runtime/regression.py) and the output sinks (sinks/). The
device-state gauge is one-hot over this package's states
(runtime/device_health.py STATES: no degraded state, so no cooldown or
shadow series). `/hotspots` serves the rollups' top K and `/diff` the
sentinel's verdicts or a range diff over the rollups; each answers 503
when its store is off. The soak is not in this package: its families
are absent.
"""

from __future__ import annotations

import html
import json
import math
import sys
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


# -- shared query-parameter validation ----------------------------------------
# The contract every helper keeps: a malformed value raises ValueError and
# the handler turns it into a 400, never a dropped connection or a 500.


def pop_float(params: dict, name: str, default=None):
    """One FINITE float query parameter, popped. ?t0=inf (or a value
    whose later *1e9 would overflow int conversion) must be a 400."""
    if name not in params:
        return default
    v = float(params.pop(name))
    if not math.isfinite(v):
        raise ValueError(f"non-finite {name}")
    return v


def pop_timeout(params: dict, default: float = 15.0,
                cap: float = 60.0) -> float:
    """timeout= with the [0, cap] clamp: negative/non-finite is a caller
    bug (ValueError -> 400), anything past the cap is capped, so no
    request parks a server thread on the listener indefinitely."""
    t = pop_float(params, "timeout", default)
    if t < 0:
        raise ValueError("negative timeout")
    return min(t, cap)


def pop_tenant(params: dict) -> None:
    """`tenant=` shorthand: the tenant identity as a label selector term
    (runtime/admission.py TENANT_LABEL), validated in place so a
    malformed value is a 400, not a silent empty match."""
    if "tenant" not in params:
        return
    from parca_agent_tpu_torch.runtime.admission import (
        TENANT_LABEL,
        validate_tenant,
    )

    params[TENANT_LABEL] = validate_tenant(params.pop("tenant"))


def pop_time_range(params: dict) -> tuple:
    """?range=S (seconds back from now) or explicit ?t0=/?t1= (unix
    seconds) -> (t0_s, t1_s), either side None when unconstrained."""
    t0_s = t1_s = None
    rng = pop_float(params, "range")
    if rng is not None:
        if rng <= 0:
            raise ValueError("range must be > 0")
        t1_s = time.time()
        t0_s = t1_s - rng
    v = pop_float(params, "t0")
    if v is not None:
        t0_s = v
    v = pop_float(params, "t1")
    if v is not None:
        t1_s = v
    return t0_s, t1_s


def pop_k_scope(params: dict) -> tuple:
    """?k= / ?scope=local|fleet for the rollup-backed endpoints."""
    k = int(params.pop("k")) if "k" in params else None
    scope = params.pop("scope", "local")
    if (k is not None and k < 1) or scope not in ("local", "fleet"):
        raise ValueError("bad k/scope")
    return k, scope


def render_status_page(profilers, version: str = "dev",
                       capture_info: dict | None = None) -> str:
    rows = []
    if capture_info:
        kv = ", ".join(f"{html.escape(str(k))}: {html.escape(str(v))}"
                       for k, v in capture_info.items())
        rows.append(f"<p>capture: {kv}</p>")
    for p in profilers:
        rows.append(
            f"<h2>{html.escape(p.name)}</h2>"
            f"<p>attempts: {p.metrics.attempts_total}, "
            f"errors: {p.metrics.errors_total}, "
            f"profiles written: {p.metrics.profiles_written}, "
            f"samples: {p.metrics.samples_aggregated}</p>"
            f"<p>last error: "
            f"{html.escape('' if p.last_error is None else str(p.last_error))}"
            f"</p>"
        )
        procs = []
        for pid, err in sorted(p.process_last_errors.items()):
            state = "ok" if err is None else html.escape(str(err))
            procs.append(
                f"<tr><td>{pid}</td><td>{state}</td>"
                f"<td><a href='/query?pid={pid}'>profile</a></td></tr>"
            )
        if procs:
            rows.append(
                "<table><tr><th>pid</th><th>state</th><th></th></tr>"
                + "".join(procs) + "</table>"
            )
    return (
        "<!doctype html><html><head><title>parca-agent-tpu</title></head>"
        f"<body><h1>parca-agent-tpu ({html.escape(version)})</h1>"
        + "".join(rows) + "</body></html>"
    )


def escape_label_value(v) -> str:
    """Prometheus text-format label-value escaping: backslash, double
    quote, and newline must be escaped or the exposition is unparseable
    (a binary path or an error string in a label would corrupt the
    whole scrape)."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_value(v) -> str:
    if isinstance(v, bool):
        return str(int(v))
    if isinstance(v, float):
        return format(v, ".10g")
    return str(v)


class _MetricsBuffer:
    """Collects samples grouped by metric family so the rendered text is
    strict Prometheus exposition: one ``# TYPE`` line per family, all of
    a family's samples contiguous under it, label values escaped. The
    first type registered for a family wins (families are single-typed
    by definition)."""

    def __init__(self):
        self._fams: dict[str, list] = {}  # family -> [type, [lines]]

    def sample(self, family: str, suffix: str, labels, value,
               mtype: str = "gauge") -> None:
        fam = self._fams.setdefault(family, [mtype, []])
        if isinstance(labels, str):
            lab = labels  # pre-rendered "{...}" (caller escaped)
        elif labels:
            lab = "{" + ",".join(
                f'{k}="{escape_label_value(v)}"'
                for k, v in labels.items()) + "}"
        else:
            lab = ""
        fam[1].append(f"{family}{suffix}{lab} {_fmt_value(value)}")

    def emit(self, name: str, value, labels=None,
             mtype: str | None = None) -> None:
        if mtype is None:
            # The naming convention: *_total counters, last-value gauges
            # otherwise.
            mtype = "counter" if name.endswith("_total") else "gauge"
        self.sample(name, "", labels, value, mtype)

    def histogram(self, family: str, labels: dict, export: dict) -> None:
        """One labeled series of a histogram family from a
        StageHistogram.export() dict (runtime/trace.py): cumulative
        ``_bucket`` samples, the mandatory ``le="+Inf"`` bucket, and the
        ``_sum``/``_count`` samples."""
        for le, c in export["buckets"]:
            self.sample(family, "_bucket",
                        {**labels, "le": format(le, ".9g")}, c,
                        mtype="histogram")
        self.sample(family, "_bucket", {**labels, "le": "+Inf"},
                    export["count"], mtype="histogram")
        self.sample(family, "_sum", labels, export["sum_s"],
                    mtype="histogram")
        self.sample(family, "_count", labels, export["count"],
                    mtype="histogram")

    def render(self) -> str:
        out = []
        for fam, (mtype, lines) in self._fams.items():
            out.append(f"# TYPE {fam} {mtype}")
            out.extend(lines)
        return "\n".join(out) + "\n"


def _emit_profiler(emit, p) -> None:
    """One window loop's families (profiler/cpu.py)."""
    lab = {"profiler": p.name}
    m = p.metrics
    emit("parca_agent_profiler_attempts_total", m.attempts_total, lab)
    emit("parca_agent_profiler_errors_total", m.errors_total, lab)
    emit("parca_agent_profiler_profiles_written_total", m.profiles_written,
         lab)
    emit("parca_agent_profiler_samples_aggregated_total",
         m.samples_aggregated, lab)
    emit("parca_agent_profiler_attempt_duration_seconds",
         m.last_attempt_duration_s, lab)
    emit("parca_agent_profiler_symbolize_duration_seconds",
         m.last_symbolize_duration_s, lab)
    emit("parca_agent_profiler_aggregate_duration_seconds",
         m.last_aggregate_duration_s, lab)
    emit("parca_agent_profiler_encode_duration_seconds",
         m.last_encode_duration_s, lab)
    emit("parca_agent_profiler_encode_backpressure_total",
         m.encode_backpressure_total, lab)
    emit("parca_agent_profiler_encode_deadline_hits_total",
         m.encode_deadline_hits_total, lab)
    emit("parca_agent_profiler_device_abandoned_ok_total",
         m.device_abandoned_ok_total, lab)
    emit("parca_agent_profiler_device_abandoned_err_total",
         m.device_abandoned_err_total, lab)
    pipe = getattr(p, "pipeline", None)
    if pipe is not None:
        # Encode-pipeline observability: the encode/ship work off the
        # capture thread, the hand-off cost left on it, and liveness.
        emit("parca_agent_encode_pipeline_disabled", int(pipe.disabled), lab)
        for k, v in pipe.stats.items():
            emit(f"parca_agent_encode_pipeline_{k}",
                 round(v, 6) if isinstance(v, float) else v, lab)
    perf = getattr(getattr(p, "symbolizer", None), "perf", None)
    perf_stats = getattr(perf, "stats", None)
    if isinstance(perf_stats, dict):
        # JIT perf-map cache: content reparses, stat-hit short-circuits,
        # churn-abuse trips.
        emit("parca_agent_perfmap_reparse_total",
             perf_stats.get("reparse_total", 0), lab)
        emit("parca_agent_perfmap_stat_hits_total",
             perf_stats.get("stat_hits_total", 0), lab)
        emit("parca_agent_perfmap_churn_trips_total",
             perf_stats.get("churn_trips_total", 0), lab)
    agg_stats = getattr(getattr(p, "aggregator", None), "stats", None)
    if isinstance(agg_stats, dict) and "windows" in agg_stats:
        # The close: what the last close fetched (a delta close moves the
        # touched blocks, a full close the n_fetch prefix) and the
        # flip/delta/retry counters; then the feed's fold (rows in vs
        # dispatched) and the cross-drain carry cache.
        for name, key in (
                ("parca_agent_close_fetch_rows", "fetch_rows_last"),
                ("parca_agent_close_fetch_bytes", "fetch_bytes_last"),
                ("parca_agent_close_fetch_bytes_total", "fetch_bytes_total"),
                ("parca_agent_close_buffer_flips_total", "buffer_flips"),
                ("parca_agent_close_delta_closes_total", "delta_closes"),
                ("parca_agent_close_full_closes_total", "full_closes"),
                ("parca_agent_close_delta_retries_total", "delta_retries"),
                ("parca_agent_close_delta_fallbacks_total",
                 "delta_fallbacks"),
                ("parca_agent_feed_coalesce_rows_in_total",
                 "coalesce_rows_in"),
                ("parca_agent_feed_coalesce_rows_out_total",
                 "coalesce_rows_out"),
                ("parca_agent_feed_coalesce_fallbacks_total",
                 "coalesce_fallbacks"),
                ("parca_agent_feed_carry_rows_in_total", "carry_rows_in"),
                ("parca_agent_feed_carry_hits_total", "carry_hits"),
                ("parca_agent_feed_carry_mass_total", "carry_mass"),
                ("parca_agent_feed_carry_entries", "carry_entries"),
                ("parca_agent_feed_carry_flushes_total", "carry_flushes"),
                ("parca_agent_feed_carry_fallbacks_total",
                 "carry_fallbacks"),
                ("parca_agent_feed_miss_vec_inserts_total",
                 "miss_vec_inserts")):
            emit(name, agg_stats.get(key, 0), lab)
    feeder = getattr(p, "feeder", None)
    if feeder is not None and getattr(feeder, "stats", None):
        # The ingest ceiling: the share of the window the capture thread
        # spent feeding (1.0: the feed is the window).
        window_s = float(getattr(p, "duration_s", 0.0)) or 10.0
        feed_s = float(feeder.stats.get("last_window_feed_s", 0.0))
        emit("parca_agent_feed_saturation", round(feed_s / window_s, 6), lab)
        emit("parca_agent_feed_seconds", round(feed_s, 6), lab)
    enc = getattr(p, "encoder", None)
    if enc is not None and getattr(enc, "stats", None):
        for k, v in enc.stats.items():
            emit(f"parca_agent_encoder_{k}",
                 round(v, 6) if isinstance(v, float) else v, lab)


def _emit_device_telemetry(buf, emit, device_telemetry) -> None:
    """The device flight recorder (runtime/device_telemetry.py): latched
    identity, per-kernel histograms split compile|execute, shape and
    recompile counts, backend resolution, transfers, the window budget."""
    ident = device_telemetry.ensure_identity()
    if ident:
        emit("parca_agent_device_info", 1,
             {k: str(v) for k, v in sorted(ident.items())})
    khists = device_telemetry.export_kernel_histograms()
    for kernel, event, h in khists:
        buf.histogram("parca_agent_kernel_duration_seconds",
                      {"kernel": kernel, "event": event}, h)
    for kernel, event, h in khists:
        lab = {"kernel": kernel, "event": event}
        emit("parca_agent_kernel_p50_seconds", round(h["p50_s"], 6), lab)
        emit("parca_agent_kernel_p99_seconds", round(h["p99_s"], 6), lab)
        emit("parca_agent_kernel_max_seconds", round(h["max_s"], 6), lab)
        if event == "compile":
            emit("parca_agent_kernel_compiles_total", h["count"],
                 {"kernel": kernel})
    for kernel, n in device_telemetry.shape_counts().items():
        emit("parca_agent_kernel_shapes", n, {"kernel": kernel})
        emit("parca_agent_kernel_recompiles_total", max(0, n - 1),
             {"kernel": kernel})
    for kernel, rec in device_telemetry.backends().items():
        resolved = rec["resolved"] or "unresolved"
        # One-hot over the hand kernel, its plain version and whatever
        # this kernel resolved to.
        for backend in sorted({"cuda", "plain", resolved}):
            emit("parca_agent_kernel_backend", int(backend == resolved),
                 {"kernel": kernel, "backend": backend})
        emit("parca_agent_kernel_fallback", int(rec["fallback"]),
             {"kernel": kernel})
        if rec["interpret"] is not None:
            emit("parca_agent_kernel_interpret", int(rec["interpret"]),
                 {"kernel": kernel})
    for kernel, direction, nbytes, ops in device_telemetry.transfers():
        lab = {"kernel": kernel, "direction": direction}
        emit("parca_agent_transfer_bytes_total", nbytes, lab)
        emit("parca_agent_transfer_ops_total", ops, lab)
    budget = device_telemetry.budget_export()
    buf.histogram("parca_agent_window_budget_used_ratio", {}, budget["hist"])
    emit("parca_agent_window_budget_period_seconds", budget["period_s"])
    emit("parca_agent_window_budget_windows_total", budget["windows_total"])
    emit("parca_agent_window_budget_windows_over_total",
         budget["windows_over_budget_total"])
    emit("parca_agent_window_budget_used_last_ratio",
         round(budget["budget_used_last"], 6))
    for k, v in dict(device_telemetry.stats).items():
        name = f"parca_agent_device_telemetry_{k}"
        emit(name if name.endswith("_total") else name + "_total", v)


def render_metrics(profilers, batch_client=None, extra: dict | None = None,
                   supervisor=None, quarantine=None,
                   device_health=None, statics_store=None,
                   recorder=None, identity=None,
                   device_telemetry=None, hotspots=None, sinks=None,
                   admission=None, regression=None) -> str:
    """Prometheus text exposition of the agent's metric contract: every
    family carries a ``# TYPE`` line and label values are escaped (the
    strict parser of tests/test_metrics_format.py holds the output)."""
    buf = _MetricsBuffer()
    emit = buf.emit

    for p in profilers:
        _emit_profiler(emit, p)
    if batch_client is not None:
        emit("parca_agent_remote_write_batches_sent_total",
             batch_client.sent_batches)
        emit("parca_agent_remote_write_errors_total", batch_client.send_errors)
        series, samples = batch_client.buffered()
        emit("parca_agent_remote_write_buffered_series", series)
        emit("parca_agent_remote_write_buffered_samples", samples)
        # The ship path's footprint: the buffer in memory, the spool on
        # disk, and the spool's own loss accounting.
        emit("parca_agent_remote_write_buffer_bytes",
             batch_client.buffer_bytes())
        segs, sbytes = batch_client.replay_backlog()
        emit("parca_agent_spool_segments", segs)
        emit("parca_agent_spool_bytes", sbytes)
        emit("parca_agent_replay_lag_seconds",
             round(batch_client.replay_lag_s(), 3))
        for k, v in batch_client.spool_stats().items():
            emit(f"parca_agent_spool_{k}", v)
        for k, v in batch_client.stats.items():
            emit(f"parca_agent_remote_write_{k}", v)
    if supervisor is not None:
        # Per-actor supervision state, and the overall health as a 0/1/2
        # gauge (healthy/degraded/dead).
        for name, h in supervisor.health().items():
            lab = {"actor": name}
            emit("parca_agent_actor_restarts_total", h["restarts"], lab)
            emit("parca_agent_actor_alive", int(h["alive"]), lab)
            emit("parca_agent_actor_degraded",
                 int(h["state"] == "degraded"), lab)
        emit("parca_agent_health",
             {"healthy": 0, "degraded": 1, "dead": 2}[supervisor.overall()])
    if quarantine is not None:
        # Ingest containment: lifecycle states and ladder levels are
        # separate families, each summing to a true pid count.
        counts = quarantine.counts()
        for state in ("quarantined", "probation", "watched"):
            emit("parca_agent_quarantine_pids", counts[state],
                 {"state": state})
        for level in ("addresses", "scalar"):
            emit("parca_agent_quarantine_ladder_pids",
                 counts[f"level_{level}"], {"level": level})
        for k, v in quarantine.stats.items():
            emit(f"parca_agent_quarantine_{k}", v)
    if device_health is not None:
        # The card's state, one-hot over this package's states, and its
        # fault counters.
        from parca_agent_tpu_torch.runtime.device_health import STATES

        snap = device_health.snapshot()
        for state in STATES:
            emit("parca_agent_device_state",
                 int(snap["state"] == state), {"state": state})
        for k, v in snap["stats"].items():
            emit(f"parca_agent_device_{k}", v)
    if statics_store is not None:
        # Warm-statics snapshot: write/adopt outcomes, the file's age and
        # size.
        for k, v in statics_store.stats.items():
            emit(f"parca_agent_statics_{k}",
                 round(v, 3) if isinstance(v, float) else v)
        info = statics_store.snapshot_info()
        emit("parca_agent_statics_snapshot_present", int(info["present"]))
        emit("parca_agent_statics_snapshot_file_bytes", info["bytes"])
        if info["age_s"] is not None:
            emit("parca_agent_statics_snapshot_age_seconds", info["age_s"])
    if recorder is not None:
        # The window flight recorder: one histogram per lifecycle stage,
        # percentile gauges, and the recorder's own counters.
        hists = recorder.export_histograms()
        for stage, h in hists.items():
            buf.histogram("parca_agent_window_stage_duration_seconds",
                          {"stage": stage}, h)
        for stage, h in hists.items():
            emit("parca_agent_window_stage_p50_seconds",
                 round(h["p50_s"], 6), {"stage": stage})
            emit("parca_agent_window_stage_p90_seconds",
                 round(h["p90_s"], 6), {"stage": stage})
            emit("parca_agent_window_stage_p99_seconds",
                 round(h["p99_s"], 6), {"stage": stage})
            emit("parca_agent_window_stage_max_seconds",
                 round(h["max_s"], 6), {"stage": stage})
        for k, v in recorder.stats.items():
            name = f"parca_agent_trace_{k}"
            emit(name if name.endswith("_total") else name + "_total", v)
    if device_telemetry is not None:
        _emit_device_telemetry(buf, emit, device_telemetry)
    if hotspots is not None:
        # Hotspot rollup observability (docs/hotspots.md): per-level
        # ring population/footprint/evictions for BOTH scopes, fold and
        # query counters, and the fleet-round health the degrade path
        # promises operators (ok/degraded rounds, staleness, age).
        m = hotspots.metrics()
        for lv in m["levels"]:
            lab = {"level": lv["name"], "scope": lv["scope"]}
            emit("parca_agent_hotspot_level_summaries", lv["summaries"],
                 lab)
            emit("parca_agent_hotspot_level_bytes", lv["bytes"], lab)
            emit("parca_agent_hotspot_level_evictions_total",
                 lv["evictions"], lab)
        emit("parca_agent_hotspot_windows_folded_total",
             m["windows_folded"])
        emit("parca_agent_hotspot_fold_errors_total", m["fold_errors"])
        emit("parca_agent_hotspot_last_fold_seconds",
             round(m["last_fold_s"], 6))
        emit("parca_agent_hotspot_queries_total", m["queries_total"])
        emit("parca_agent_hotspot_query_errors_total", m["query_errors"])
        emit("parca_agent_hotspot_context_entries", m["context_entries"])
        emit("parca_agent_hotspot_fleet_rounds_ok_total",
             m["fleet_rounds_ok"])
        emit("parca_agent_hotspot_fleet_rounds_degraded_total",
             m["fleet_rounds_degraded"])
        emit("parca_agent_hotspot_fleet_stale", int(m["stale"]))
        if "fleet_age_s" in m:
            emit("parca_agent_hotspot_fleet_age_seconds", m["fleet_age_s"])
    if admission is not None:
        # Multi-tenant admission (docs/robustness.md "multi-tenant
        # admission"): per-tenant usage/ladder gauges at BOUNDED
        # cardinality — the controller hands back the top-N tenants by
        # last-window mass plus every currently-degraded tenant and one
        # "other" rollup, so a pod-churn host can never blow up the
        # scrape — and the admission/resolver counters.
        m = admission.metrics()
        for t in m["tenants"]:
            lab = {"tenant": t["tenant"]}
            if t["tenant"] != "other":
                # The rollup's membership is recomputed per scrape, so
                # a cumulative "other" series would DROP whenever a
                # tenant migrates into the top-N — a fake counter
                # reset. Only named tenants get the monotonic family;
                # the rollup keeps the last-window gauges below.
                emit("parca_agent_tenant_samples_total", t["samples"],
                     lab)
            emit("parca_agent_tenant_window_samples",
                 t["window_samples"], lab)
            emit("parca_agent_tenant_window_pids", t["pids"], lab)
            emit("parca_agent_tenant_ladder_level", t["level"], lab)
            emit("parca_agent_tenant_over_quota", t["over_quota"], lab)
        stats = dict(m["stats"])
        # Fork/exec-storm containment gets its own first-class family
        # (the zoo's fork-storm bar keys on it); the rest of the
        # controller's counters export under the generic prefix.
        emit("parca_agent_fork_storm_shed_total",
             stats.pop("fork_storm_sheds_total", 0))
        for k, v in stats.items():
            emit(f"parca_agent_admission_{k}", v)
        for k, v in m["resolver"].items():
            emit(f"parca_agent_tenant_{k}", v)
    if identity is not None:
        # Generation-stamped process identity (process/identity.py).
        m = identity.metrics()
        emit("parca_agent_pid_reuse_detected_total",
             m.get("reuse_detected_total", 0))
        emit("parca_agent_pid_identity_checks_total",
             m.get("checks_total", 0))
        emit("parca_agent_pid_identity_invalidations_total",
             m.get("invalidations_total", 0))
        emit("parca_agent_pid_identity_errors_total",
             m.get("errors_total", 0))
    if regression is not None:
        # Regression sentinel (docs/regression.md): verdict counters by
        # kind, the fold/seal/baseline lifecycle counters, judgment
        # state gauges (groups, frozen baselines, worst drift), and the
        # crash-only persistence + staleness-mark accounting.
        m = regression.metrics()
        for kind, n in sorted(m.pop("verdicts").items()):
            emit("parca_agent_regression_verdicts_total", n,
                 {"kind": kind})
        for k in ("windows_folded", "windows_skipped", "fold_errors",
                  "rollups_sealed", "groups_dropped", "keys_overflow",
                  "rows_dropped", "verdicts_suppressed",
                  "alerts_dropped", "baselines_frozen",
                  "baseline_saves", "baseline_save_errors",
                  "baselines_adopted", "baseline_adopt_errors",
                  "stale_marks", "stale_mark_errors", "queries",
                  "query_errors"):
            emit(f"parca_agent_regression_{k}_total", m[k])
        emit("parca_agent_regression_groups", m["groups"])
        emit("parca_agent_regression_baselines", m["baselines"])
        emit("parca_agent_regression_alerts_pending",
             m["alerts_pending"])
        emit("parca_agent_regression_drift_max", m["drift_max"])
        emit("parca_agent_regression_last_fold_seconds",
             round(m["last_fold_s"], 6))
    if sinks is not None:
        # Output-backend sinks (docs/sinks.md): the contract trio —
        # windows/bytes/errors per sink — as labeled families, every
        # backend-specific stat under its own family, plus the series
        # sink's per-label-set cumulative sample counts (the OTLP-style
        # scalar series the sink exists to serve).
        m = sinks.metrics()
        reg = m.pop("_registry", {})
        for name, st in sorted(m.items()):
            lab = {"sink": name}
            emit("parca_agent_sink_windows_total", st.pop("windows", 0),
                 lab)
            emit("parca_agent_sink_errors_total", st.pop("errors", 0),
                 lab)
            emit("parca_agent_sink_bytes_total", st.pop("bytes", 0), lab)
            emit("parca_agent_sink_last_emit_seconds",
                 round(st.pop("last_emit_s", 0.0), 6), lab)
            for k, v in sorted(st.items()):
                if isinstance(v, (int, float)):
                    emit(f"parca_agent_sink_{k}",
                         round(v, 6) if isinstance(v, float) else v, lab)
        emit("parca_agent_sink_windows_skipped_total",
             reg.get("windows_skipped", 0))
        emit("parca_agent_sink_capture_errors_total",
             reg.get("capture_errors", 0))
        series_sink = sinks.sink("series")
        if series_sink is not None:
            for pt in series_sink.series():
                buf.sample("parca_agent_sink_series_samples_total", "",
                           pt["labels"], pt["value"], mtype="counter")
    for k, v in (extra or {}).items():
        # Extra metrics may arrive with pre-rendered labels
        # ("name{k=\"v\"}"): split so the family still gets its TYPE
        # line; the caller owns the escaping (escape_label_value).
        name, brace, rest = k.partition("{")
        buf.emit(name, v, labels=("{" + rest) if brace else None)
    return buf.render()


class AgentHTTPServer:
    """The agent's HTTP server. Binds ``host:port`` in the constructor
    (port 0: any free port, read back from ``port``); start() serves on a
    daemon thread named "http", stop() shuts it down and closes the
    socket."""

    def __init__(self, host: str = "127.0.0.1", port: int = 7071,
                 profilers=(), batch_client=None, listener=None,
                 version: str = "dev", extra_metrics=None,
                 capture_info=None, supervisor=None, quarantine=None,
                 device_health=None, statics_store=None, recorder=None,
                 identity=None, device_telemetry=None, hotspots=None,
                 sinks=None, admission=None, regression=None):
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, body: bytes, ctype="text/plain"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                url = urllib.parse.urlparse(self.path)
                if url.path == "/":
                    info = outer.capture_info() if outer.capture_info else None
                    self._send(200, render_status_page(
                        outer.profilers, outer.version, info).encode(),
                        "text/html")
                elif url.path == "/metrics":
                    extra = outer.extra_metrics() if outer.extra_metrics else {}
                    self._send(200, render_metrics(
                        outer.profilers, outer.batch_client, extra,
                        supervisor=outer.supervisor,
                        quarantine=outer.quarantine,
                        device_health=outer.device_health,
                        statics_store=outer.statics_store,
                        recorder=outer.recorder,
                        identity=outer.identity,
                        device_telemetry=outer.device_telemetry,
                        hotspots=outer.hotspots, sinks=outer.sinks,
                        admission=outer.admission,
                        regression=outer.regression).encode())
                elif url.path == "/healthy":
                    self._send(200, b"ok\n")
                elif url.path == "/healthz":
                    self._healthz()
                elif url.path == "/query":
                    self._query(url)
                elif url.path == "/hotspots":
                    self._hotspots(url)
                elif url.path == "/diff":
                    self._diff(url)
                elif url.path == "/debug/windows":
                    self._debug_windows(url)
                elif url.path == "/debug/device":
                    self._debug_device(url)
                elif url.path.startswith("/debug/trace/"):
                    self._debug_trace(url)
                elif url.path.startswith("/debug/pprof"):
                    self._debug_pprof(url)
                else:
                    self._send(404, b"not found\n")

            def _limit(self, url):
                """?limit=N (0: all); None after a 400 was sent."""
                params = dict(urllib.parse.parse_qsl(url.query))
                try:
                    limit = int(params.get("limit", "0"))
                except ValueError:
                    limit = -1
                if limit < 0:
                    self._send(400, b"bad limit parameter\n")
                    return None
                return limit

            def _debug_windows(self, url):
                """The window flight recorder's ring as wide-event JSON:
                one object per completed window trace, oldest first;
                ?limit=N caps the tail."""
                if outer.recorder is None:
                    self._send(503, b"window tracing not enabled\n")
                    return
                limit = self._limit(url)
                if limit is None:
                    return
                body = {
                    "traces": outer.recorder.traces(limit=limit or None),
                    "stats": dict(outer.recorder.stats),
                    "stage_percentiles": outer.recorder.percentiles(),
                }
                self._send(200, json.dumps(body, indent=1).encode(),
                           "application/json")

            def _debug_device(self, url):
                """The device flight recorder's state as JSON: the full
                snapshot plus the bounded kernel-event and window-SLO
                timelines; ?limit=N caps both rings."""
                if outer.device_telemetry is None:
                    self._send(503, b"device telemetry not enabled\n")
                    return
                limit = self._limit(url)
                if limit is None:
                    return
                body = dict(outer.device_telemetry.snapshot())
                body["timeline"] = outer.device_telemetry.timeline(
                    limit=limit or None)
                self._send(200, json.dumps(body, indent=1).encode(),
                           "application/json")

            def _debug_trace(self, url):
                """One window's trace by sequence number."""
                if outer.recorder is None:
                    self._send(503, b"window tracing not enabled\n")
                    return
                tail = url.path.removeprefix("/debug/trace/").strip("/")
                try:
                    seq = int(tail)
                except ValueError:
                    self._send(400, b"bad trace seq\n")
                    return
                got = outer.recorder.trace(seq)
                if got is None:
                    self._send(404, b"trace not in the ring\n")
                    return
                self._send(200, json.dumps(got, indent=1).encode(),
                           "application/json")

            def _debug_pprof(self, url):
                """Self-profiling endpoints (reference main.go:269-275):
                the agent profiles its own threads into pprof."""
                params = dict(urllib.parse.parse_qsl(url.query))
                name = url.path.removeprefix("/debug/pprof").strip("/")
                if name == "":
                    self._send(200, (
                        b"self-profile endpoints:\n"
                        b"  /debug/pprof/profile?seconds=N  "
                        b"sampling wall-clock profile of the agent\n"
                        b"  /debug/pprof/heap?seconds=N     "
                        b"tracemalloc heap profile over a bounded "
                        b"N-second tracing window\n"
                        b"  /debug/pprof/cmdline            "
                        b"agent command line\n"))
                elif name == "cmdline":
                    self._send(200, "\x00".join(sys.argv).encode())
                elif name in ("profile", "heap"):
                    from parca_agent_tpu_torch.profiler.selfprofile import (
                        heap_self,
                        profile_self,
                    )

                    fn, default_s = ((profile_self, "10")
                                     if name == "profile"
                                     else (heap_self, "5"))
                    try:
                        seconds = float(params.get("seconds", default_s))
                    except ValueError:
                        self._send(400, b"bad seconds parameter\n")
                        return
                    if not 0 < seconds <= 300:
                        self._send(400, b"seconds must be in (0, 300]\n")
                        return
                    self._send_attachment(fn(seconds), f"{name}.pb.gz")
                else:
                    self._send(404, b"unknown profile\n")

            def _healthz(self):
                """Supervised readiness: per-actor states from the run
                group (healthy/degraded/dead/exited). 200 while the agent
                is healthy or degraded; 503 once a critical actor is
                dead. Without a supervisor, plain liveness like /healthy.
                The quarantine, device, statics, hotspot, sink,
                admission, process-identity and regression sections are
                surfaced for operators and never decide the status."""
                body = {"status": "healthy", "actors": {}}
                code, indent = 200, None
                if outer.supervisor is not None:
                    status = outer.supervisor.overall()
                    body = {"status": status,
                            "actors": outer.supervisor.health()}
                    code, indent = (503 if status == "dead" else 200), 1
                if outer.quarantine is not None:
                    body["quarantine"] = outer.quarantine.snapshot()
                if outer.device_health is not None:
                    body["device"] = outer.device_health.snapshot()
                if outer.statics_store is not None:
                    body["statics"] = outer.statics_store.snapshot_info()
                if outer.hotspots is not None:
                    body["hotspots"] = outer.hotspots.snapshot()
                if outer.sinks is not None:
                    body["sinks"] = outer.sinks.snapshot()
                if outer.admission is not None:
                    body["admission"] = outer.admission.snapshot()
                if outer.identity is not None:
                    body["process_identity"] = outer.identity.snapshot()
                if outer.regression is not None:
                    body["regression"] = outer.regression.snapshot()
                self._send(code, json.dumps(body, indent=indent).encode(),
                           "application/json")

            def _send_attachment(self, body: bytes, filename: str):
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("Content-Disposition",
                                 f'attachment; filename="{filename}"')
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _hotspots(self, url):
                """Top-K hottest stacks from the pre-merged rollups
                (docs/hotspots.md): ?k=N, ?t0=/-t1= (unix seconds) or
                ?range=S (seconds back from now), ?scope=local|fleet;
                every other parameter is a label selector term. Answers
                come from sealed summaries — this handler never touches
                the capture/close path."""
                if outer.hotspots is None:
                    self._send(503, b"hotspot rollups not enabled\n")
                    return
                params = dict(urllib.parse.parse_qsl(url.query))
                try:
                    # Shared hygiene (module helpers): tenant selector
                    # validation, float finiteness, k/scope — the same
                    # gates /query and /diff ride.
                    pop_tenant(params)
                    k, scope = pop_k_scope(params)
                    t0_s, t1_s = pop_time_range(params)
                    body = outer.hotspots.query(
                        k=k, t0_s=t0_s, t1_s=t1_s, selector=params,
                        scope=scope)
                except (ValueError, TypeError, OverflowError) as e:
                    outer.hotspots.count_query_error()
                    self._send(400, f"bad hotspot query: {e}\n".encode())
                    return
                self._send(200, json.dumps(body, indent=1).encode(),
                           "application/json")

            def _diff(self, url):
                """The regression sentinel's read surface
                (docs/regression.md). Two modes:

                  * default — recent verdicts + per-group judgment
                    state (?tenant=, ?build=, ?kind=, ?since=,
                    ?limit=);
                  * range diff — ?a0=&a1=&b0=&b1= (unix seconds):
                    range A minus range B computed over the hotspot
                    store's rollup levels (?k=, ?scope=local|fleet,
                    label selector terms), every entry carrying
                    exact/estimate bounds.

                Parameter hygiene rides the same shared helpers as
                /query and /hotspots; malformed values are 400s."""
                if outer.regression is None:
                    self._send(503, b"regression sentinel not enabled\n")
                    return
                params = dict(urllib.parse.parse_qsl(url.query))
                try:
                    pop_tenant(params)
                    bounds = [pop_float(params, n)
                              for n in ("a0", "a1", "b0", "b1")]
                    if any(b is not None for b in bounds):
                        if any(b is None for b in bounds):
                            raise ValueError(
                                "a range diff needs all of a0,a1,b0,b1")
                        if outer.hotspots is None:
                            self._send(503, b"range diff needs hotspot "
                                            b"rollups\n")
                            return
                        k, scope = pop_k_scope(params)
                        body = outer.regression.diff_ranges(
                            outer.hotspots, *bounds, k=k,
                            selector=params, scope=scope)
                    else:
                        since = pop_float(params, "since")
                        limit = int(params.pop("limit", "100"))
                        if limit < 1:
                            raise ValueError("limit must be >= 1")
                        tenant = params.pop("tenant", None)
                        build = params.pop("build", None)
                        kind = params.pop("kind", None)
                        if params:
                            # Unlike the selector-consuming range mode,
                            # verdict mode has a closed parameter set —
                            # a typo'd filter must be a 400, not an
                            # unfiltered 200 that reads as "no match".
                            raise ValueError(
                                f"unknown parameters {sorted(params)}")
                        body = outer.regression.verdicts(
                            tenant=tenant, build=build, kind=kind,
                            since_s=since, limit=limit)
                except (ValueError, TypeError, OverflowError) as e:
                    outer.regression.count_query_error()
                    self._send(400, f"bad diff query: {e}\n".encode())
                    return
                self._send(200, json.dumps(body, indent=1).encode(),
                           "application/json")

            def _query(self, url):
                if outer.listener is None:
                    self._send(503, b"no listener\n")
                    return
                params = dict(urllib.parse.parse_qsl(url.query))
                try:
                    timeout = pop_timeout(params)
                    pop_tenant(params)
                except (ValueError, TypeError) as e:
                    self._send(400, f"bad query parameter: {e}\n".encode())
                    return
                want = params

                def match(labels):
                    return all(labels.get(k) == v for k, v in want.items())

                got = outer.listener.next_matching_profile(match, timeout)
                if got is None:
                    self._send(404, b"no matching profile observed\n")
                    return
                labels, sample = got
                body = json.dumps({"labels": labels}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("X-Profile-Labels", body.decode())
                self.send_header("Content-Length", str(len(sample)))
                self.end_headers()
                self.wfile.write(sample)

        self.profilers = list(profilers)
        self.batch_client = batch_client
        self.listener = listener
        self.supervisor = supervisor
        self.quarantine = quarantine
        self.device_health = device_health
        self.statics_store = statics_store
        self.recorder = recorder
        self.identity = identity
        self.device_telemetry = device_telemetry
        self.hotspots = hotspots
        self.sinks = sinks
        self.admission = admission
        self.regression = regression
        self.version = version
        self.extra_metrics = extra_metrics
        self.capture_info = capture_info
        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="http", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        if self._thread is not None:
            self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=2)
