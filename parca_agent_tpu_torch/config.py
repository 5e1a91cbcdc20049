"""YAML config file: relabel rules (reference pkg/config/config.go:25-27)
and hot reload via mtime polling + debounce (the fsnotify role,
pkg/config/reloader.go:34-165).

The port's copy of parca_agent_tpu's config.py, except that ``yaml`` is
imported when a config is parsed, not with the module: the CLI runs
without the package unless --config-path is given.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable

from parca_agent_tpu_torch.labels.relabel import RelabelConfig
from parca_agent_tpu_torch.utils.log import get_logger

_log = get_logger("config")


@dataclasses.dataclass
class Config:
    relabel_configs: list[RelabelConfig] = dataclasses.field(default_factory=list)


def load_config(text: str) -> Config:
    import yaml

    doc = yaml.safe_load(text) or {}
    raw = doc.get("relabel_configs") or []
    return Config([RelabelConfig.from_dict(d) for d in raw])


def load_config_file(path: str) -> Config:
    with open(path, "r") as f:
        return load_config(f.read())


class ConfigReloader:
    """Watch a config file; invoke callbacks with the parsed Config when its
    content changes. Component callbacks are the ComponentReloader
    registrations of the reference (main.go:547-589)."""

    def __init__(self, path: str, callbacks: list[Callable[[Config], None]],
                 poll_s: float = 1.0, debounce_s: float = 5.0):
        self._path = path
        self._callbacks = callbacks
        self._poll = poll_s
        self._debounce = debounce_s
        self._stop = threading.Event()
        self._last_content: bytes | None = None
        self.reloads = 0
        self.errors = 0

    def _read(self) -> bytes | None:
        try:
            with open(self._path, "rb") as f:
                return f.read()
        except OSError:
            return None

    def check_once(self) -> bool:
        """One poll step; True if a reload fired."""
        content = self._read()
        if content is None or content == self._last_content:
            return False
        if self._last_content is not None:
            # Debounce: require the content to be stable across the full
            # debounce window (editors and configmap propagation often
            # write multiple times in quick succession).
            self._stop.wait(self._debounce)
            settled = self._read()
            if settled != content:
                return False
        self._last_content = content
        try:
            cfg = load_config(content.decode())
        except Exception as e:
            self.errors += 1
            _log.warn("config reload failed; keeping previous config",
                      path=self._path, error=repr(e))
            return False
        for cb in self._callbacks:
            cb(cfg)
        self.reloads += 1
        _log.info("config reloaded", path=self._path,
                  relabel_rules=len(cfg.relabel_configs))
        return True

    def run(self) -> None:
        self.check_once()  # initial load counts as reload 1
        while not self._stop.is_set():
            self._stop.wait(self._poll)
            if not self._stop.is_set():
                self.check_once()

    def stop(self) -> None:
        self._stop.set()
