"""Symbolizer front-end: attach functions/lines to aggregated profiles.

Mirrors the reference's agent-side symbolization scope (pkg/symbol/
symbol.go:55-139): kernel locations through the kallsyms cache, JITed user
locations through perf maps; everything else is left for server-side
symbolization (normalized address + build id travel in the profile).

Operates on the array-shaped PidProfile: kernel locations are resolved as
one batched ksym lookup across ALL profiles of a window (one searchsorted
over the sorted symbol table), not per-address calls.

The port's copy of parca_agent_tpu's symbolize/symbolizer.py.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

from parca_agent_tpu_torch.aggregator.base import PidProfile
from parca_agent_tpu_torch.symbolize.ksym import KsymCache
from parca_agent_tpu_torch.symbolize.perfmap import PerfMapCache
from parca_agent_tpu_torch.utils.poison import PoisonInput


class Symbolizer:
    def __init__(self, ksym: KsymCache | None = None,
                 perf: PerfMapCache | None = None,
                 quarantine=None, admission=None):
        self._ksym = ksym
        self._perf = perf
        self._quarantine = quarantine
        self._admission = admission
        self.last_errors: dict[int, Exception] = {}
        self._fn_ids: dict[int, dict[str, int]] = {}

    @property
    def perf(self) -> PerfMapCache | None:
        """The perf-map cache (its stats are on /metrics)."""
        return self._perf

    def symbolize(self, profiles: Iterable[PidProfile]) -> None:
        """Fill functions/loc_lines in place for each profile. Pids on
        the degradation ladder (runtime/quarantine.py) — whether placed
        there by poison containment or by the admission layer's quotas
        (runtime/admission.py) — are skipped: their profiles ship
        addresses-only, exactly the reference's server-side-
        symbolization contract (symbol.go:55-139), and apply_ladder's
        stripping is never undone by a later symbolize pass."""
        profiles = list(profiles)
        if self._quarantine is not None:
            profiles = [p for p in profiles
                        if self._quarantine.level(p.pid) == 0]
        if self._admission is not None:
            profiles = [p for p in profiles
                        if self._admission.level_for(p.pid) == 0]
        self._fn_ids = {}
        self.last_errors = {}
        self._resolve_kernel(profiles)
        self._resolve_jit(profiles)
        self._fn_ids = {}

    def _resolve_kernel(self, profiles: list[PidProfile]) -> None:
        if self._ksym is None:
            return
        # One batched resolve across the whole window.
        all_addrs: list[int] = []
        spans: list[tuple[PidProfile, np.ndarray]] = []
        for p in profiles:
            idx = np.flatnonzero(p.loc_is_kernel)
            if len(idx):
                spans.append((p, idx))
                all_addrs.extend(int(a) for a in p.loc_address[idx])
        if not all_addrs:
            return
        try:
            names = self._ksym.resolve(np.array(all_addrs, np.uint64))
        except Exception as e:  # noqa: BLE001 - corrupt kallsyms cache
            # must cost this window its KERNEL names, not the whole
            # symbolization pass (JIT resolution still runs). Recorded
            # per profile, like _resolve_jit's guard — but NOT fed to the
            # pid error budget: kallsyms is kernel input, no pid owns it.
            for p, _ in spans:
                self.last_errors[p.pid] = e
            return
        pos = 0
        for p, idx in spans:
            base = pos
            pos += len(idx)
            try:
                self._ensure_lines(p)
                for k, loc in enumerate(idx):
                    name = names[base + k]
                    if name:
                        self._add_line(p, int(loc), name)
            except Exception as e:  # noqa: BLE001 - one profile's attach
                # failure (a poisoned profile shape) must not abort the
                # remaining profiles; the cursor math above keeps the
                # next span aligned regardless.
                self.last_errors[p.pid] = e

    def _resolve_jit(self, profiles: list[PidProfile]) -> None:
        if self._perf is None:
            return
        for p in profiles:
            # JIT candidates: user locations that fell outside every known
            # file-backed mapping (mapping_id 0), plus locations whose
            # mapping is anonymous (path "" — JIT code lives in anon rx
            # mappings) — matches the reference's "not found in object
            # files" fallback ordering (symbol.go:96-139).
            anon_ids = np.array(
                [0] + [m.id for m in p.mappings if not m.path], np.int32
            )
            idx = np.flatnonzero(
                ~p.loc_is_kernel & np.isin(p.loc_mapping_id, anon_ids)
            )
            if not len(idx):
                continue
            t0 = (self._quarantine.clock()
                  if self._quarantine is not None else 0.0)
            try:
                pmap = self._perf.map_for_pid(p.pid)
            except FileNotFoundError:
                continue
            except PoisonInput as e:
                # The pid's own perf map is poison: feed its error budget
                # (the registry decides when it trips the ladder) and
                # ship this profile without JIT names.
                self.last_errors[p.pid] = e
                if self._quarantine is not None:
                    self._quarantine.record_error(
                        p.pid, getattr(e, "site", "perfmap.parse"), e)
                continue
            except Exception as e:  # pragma: no cover - defensive
                self.last_errors[p.pid] = e
                continue
            names = pmap.lookup_many(p.loc_address[idx])
            self._ensure_lines(p)
            for loc, name in zip(idx, names):
                if name:
                    self._add_line(p, int(loc), name)
            if self._quarantine is not None:
                # Per-pid deadline over the perf-map read+parse+lookup:
                # a map that parses slowly is poison by time.
                self._quarantine.check_deadline(p.pid, t0)

    def _ensure_lines(self, p: PidProfile) -> None:
        if p.loc_lines is None:
            p.loc_lines = [[] for _ in range(p.n_locations)]

    def _add_line(self, p: PidProfile, loc_index: int, name: str) -> None:
        # Dedup function names within the profile (reference symbol.go:75-93
        # keeps one Function per name); name->1-based id index kept per
        # profile object to stay O(1) per line.
        fn_ids = self._fn_ids.setdefault(id(p), {})
        if not fn_ids and p.functions:
            fn_ids.update((f[0], i + 1) for i, f in enumerate(p.functions))
        fid = fn_ids.get(name)
        if fid is None:
            p.functions.append((name, name, "", 0))
            fid = len(p.functions)
            fn_ids[name] = fid
        p.loc_lines[loc_index].append((fid, 0))
