"""Leveled, structured (logfmt) logging.

The port's copy of parca_agent_tpu's utils/log.py (the reference's
pkg/logger): a go-kit style leveled logger emitting logfmt lines with
timestamp, level, caller and component, the level chosen by --log-level
— ``ts=... level=info caller=cpu.py:134 component=profiler msg="..."
key=value``. Built on stdlib logging under the "parca_agent_tpu_torch"
root logger, so the lines equal the original's apart from the root's
name.

Usage:
    from parca_agent_tpu_torch.utils.log import get_logger, setup_logging
    setup_logging("debug")               # once, in the CLI
    log = get_logger("profiler")
    log.info("window closed", pids=412, samples=99840)

Until setup_logging runs, the root agent logger has no handler and
follows logging's lastResort (warnings and above, the message alone, to
stderr): library users who configure logging themselves are not
surprised by double output.
"""

from __future__ import annotations

import logging
import os
import sys
import time

_ROOT = "parca_agent_tpu_torch"

LEVELS = {
    "error": logging.ERROR,
    "warn": logging.WARNING,
    "info": logging.INFO,
    "debug": logging.DEBUG,
}


def _quote(v) -> str:
    s = str(v)
    if s == "" or any(c in s for c in ' "='):
        return '"' + s.replace("\\", "\\\\").replace('"', '\\"') + '"'
    return s


class LogfmtFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        ts = time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(record.created))
        level = {logging.ERROR: "error", logging.WARNING: "warn",
                 logging.INFO: "info", logging.DEBUG: "debug"}.get(
                     record.levelno, record.levelname.lower())
        # The facade's explicitly captured caller: logging's own
        # findCaller walks `stacklevel` frames, whose accounting differs
        # between Python versions.
        caller = getattr(record, "logfmt_caller", None) \
            or f"{record.filename}:{record.lineno}"
        parts = [
            f"ts={ts}.{int(record.msecs):03d}Z",
            f"level={level}",
            f"caller={caller}",
            f"component={record.name.removeprefix(_ROOT + '.') or 'agent'}",
            f"msg={_quote(record.getMessage())}",
        ]
        for k, v in sorted(getattr(record, "logfmt_kv", {}).items()):
            parts.append(f"{k}={_quote(v)}")
        if record.exc_info and record.exc_info[1] is not None:
            parts.append(f"err={_quote(repr(record.exc_info[1]))}")
        return " ".join(parts)


class Logger:
    """Keyword-value logging facade over one stdlib logger."""

    def __init__(self, logger: logging.Logger):
        self._logger = logger

    def _log(self, level: int, msg: str, exc=None, **kv) -> None:
        if self._logger.isEnabledFor(level):
            # The real caller, captured here: frame 0 is this _log, frame
            # 1 the public method (info/debug/...), frame 2 the call site.
            try:
                f = sys._getframe(2)
                caller = (f"{os.path.basename(f.f_code.co_filename)}"
                          f":{f.f_lineno}")
            except Exception:  # noqa: BLE001 - the caller is best-effort
                caller = None
            self._logger._log(
                level, msg, (), exc_info=exc,
                extra={"logfmt_kv": kv, "logfmt_caller": caller})

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


def setup_logging(level: str = "info", stream=None) -> None:
    """Install the logfmt handler on the agent root logger at `level`
    (--log-level). Idempotent; replaces a prior agent handler."""
    if level not in LEVELS:
        raise ValueError(f"unknown log level {level!r} "
                         f"(want one of {sorted(LEVELS)})")
    root = logging.getLogger(_ROOT)
    for h in list(root.handlers):
        root.removeHandler(h)
    handler = logging.StreamHandler(stream)
    handler.setFormatter(LogfmtFormatter())
    root.addHandler(handler)
    root.setLevel(LEVELS[level])
    root.propagate = False


def reset_logging() -> None:
    """Undo setup_logging: the agent root logger back to no handler,
    level unset, propagating (an in-process caller of the CLI, such as a
    test, must not inherit its handler)."""
    root = logging.getLogger(_ROOT)
    for h in list(root.handlers):
        root.removeHandler(h)
    root.setLevel(logging.NOTSET)
    root.propagate = True
