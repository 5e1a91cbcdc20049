"""Labels manager: merge provider labels per PID, then relabel.

Role of the reference's pkg/metadata/labels/manager.go: label_set(name,
pid) merges {__name__, pid} with every provider's labels (manager.go:
71-109), applies relabel configs (drop => None, manager.go:135-162), and
caches at two tiers — the final label set for one profile duration, the
raw per-provider labels for much longer (60x) since process metadata
rarely changes (manager.go:46-58).

The port's copy of parca_agent_tpu's labels/manager.py.
"""

from __future__ import annotations

import time

from parca_agent_tpu_torch.labels.relabel import RelabelConfig, process as relabel_process
from parca_agent_tpu_torch.metadata.providers import Provider


class _TTLCache:
    """Cross-thread safe under the GIL: single dict get/set/pop ops are
    atomic, and expiry deletion uses pop(…, None) so two threads racing
    the same expired key (or a get racing purge) cannot KeyError."""

    def __init__(self, ttl_s: float, clock):
        self._ttl = ttl_s
        self._clock = clock
        self._d: dict = {}

    def get(self, key):
        hit = self._d.get(key)
        if hit is None:
            return None
        t, v = hit
        if self._clock() - t >= self._ttl:
            self._d.pop(key, None)
            return None
        return v

    def put(self, key, value) -> None:
        self._d[key] = (self._clock(), value)

    def purge(self) -> None:
        now = self._clock()
        for k in [k for k, (t, _) in list(self._d.items())
                  if now - t >= self._ttl]:
            self._d.pop(k, None)


class LabelsManager:
    def __init__(self, providers: list[Provider],
                 relabel_configs: list[RelabelConfig] | None = None,
                 profiling_duration_s: float = 10.0,
                 clock=time.monotonic):
        self._providers = providers
        self._relabel = list(relabel_configs or [])
        # Reference ratios: label cache 3x duration, provider cache 60x
        # (manager.go:46-58).
        self._label_cache = _TTLCache(3 * profiling_duration_s, clock)
        self._provider_cache = _TTLCache(60 * profiling_duration_s, clock)
        self._calls = 0

    def apply_config(self, relabel_configs: list[RelabelConfig]) -> None:
        """Hot-reload seam (reference ApplyConfig, manager.go:119-133)."""
        self._relabel = list(relabel_configs)
        self._label_cache = _TTLCache(self._label_cache._ttl,
                                      self._label_cache._clock)

    def labels(self, pid: int) -> dict[str, str]:
        """Merged, un-relabeled provider labels."""
        out: dict[str, str] = {}
        for p in self._providers:
            if p.should_cache:
                key = (p.name, pid)
                cached = self._provider_cache.get(key)
                if cached is None:
                    cached = p.labels(pid)
                    self._provider_cache.put(key, cached)
                out.update(cached)
            else:
                out.update(p.labels(pid))
        return out

    def label_set(self, name: str, pid: int) -> dict[str, str] | None:
        """Final label set for a profile, or None when relabeling drops it."""
        # Expired entries for exited PIDs are never looked up again, so a
        # periodic sweep keeps both caches bounded under PID churn.
        self._calls += 1
        if self._calls % 4096 == 0:
            self._label_cache.purge()
            self._provider_cache.purge()
        key = (name, pid)
        cached = self._label_cache.get(key)
        if cached is not None:
            return cached or None  # {} sentinel = dropped
        labels = {"__name__": name, "pid": str(pid)}
        labels.update(self.labels(pid))
        result = relabel_process(labels, self._relabel)
        self._label_cache.put(key, result if result is not None else {})
        return result
