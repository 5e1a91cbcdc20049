"""Leveled, keyword-value logging.

The facade of parca_agent_tpu's utils/log.py (the reference's
pkg/logger): `get_logger(component).warn(msg, key=value)`. Built on
stdlib logging under the "parca_agent_tpu_torch" root logger; until the
application installs a handler, warnings and above reach stderr through
logging's lastResort.
"""

from __future__ import annotations

import logging

_ROOT = "parca_agent_tpu_torch"


def _quote(v) -> str:
    s = str(v)
    if s == "" or any(c in s for c in ' "='):
        return '"' + s.replace("\\", "\\\\").replace('"', '\\"') + '"'
    return s


class Logger:
    """Keyword-value logging facade over one stdlib logger: the message
    is followed by its key=value pairs in logfmt."""

    def __init__(self, logger: logging.Logger):
        self._logger = logger

    def _log(self, level: int, msg: str, exc=None, **kv) -> None:
        if self._logger.isEnabledFor(level):
            text = " ".join([_quote(msg)] + [f"{k}={_quote(v)}"
                                             for k, v in sorted(kv.items())])
            self._logger.log(level, text, exc_info=exc, stacklevel=3)

    def debug(self, msg: str, **kv) -> None:
        self._log(logging.DEBUG, msg, **kv)

    def info(self, msg: str, **kv) -> None:
        self._log(logging.INFO, msg, **kv)

    def warn(self, msg: str, **kv) -> None:
        self._log(logging.WARNING, msg, **kv)

    def error(self, msg: str, exc: BaseException | None = None, **kv) -> None:
        self._log(logging.ERROR, msg, exc=exc, **kv)


def get_logger(component: str = "") -> Logger:
    name = f"{_ROOT}.{component}" if component else _ROOT
    return Logger(logging.getLogger(name))
