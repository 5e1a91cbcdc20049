"""crash-only-io: persistent writes are tmp + ``os.replace`` or nothing.

Crash-only persistence (agent/spool.py set the pattern; the statics
snapshot, incident dumps, and the local profile writer all inherited
it): a write that can be interrupted mid-stream must land in a tmp
sibling and be renamed into place, so the reader side never sees a
torn file — the recovery path then only has to distinguish "present"
from "absent", never "half".

Modules that hold a persistence root declare it once::

    # palint: persistence-root

In such modules, every write-mode ``open()`` (``w``/``wb``/``a``/``x``
and friends) and every ``Path.write_bytes``/``write_text`` call must
sit in a function that also calls ``os.replace`` (or ``os.rename``) —
i.e. the tmp+rename dance is local and auditable, or (better) the
write goes through ``utils/vfs.py:atomic_write_bytes``. Read-mode
opens are free. Append mode is *not* exempt: a torn append corrupts
the tail, which is why the spool frames records with CRCs and still
rewrites via tmp.
"""

from __future__ import annotations

import ast

from parca_agent_tpu_torch.tools.lint.core import Finding, Project, SourceFile

ID = "crash-only-io"

_WRITE_METHODS = ("write_bytes", "write_text")


def _write_mode(call: ast.Call) -> str | None:
    """The mode string of an ``open()`` call when it is write-ish."""
    mode = None
    if len(call.args) >= 2 and isinstance(call.args[1], ast.Constant):
        mode = call.args[1].value
    for kw in call.keywords:
        if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
            mode = kw.value.value
    if isinstance(mode, str) and any(c in mode for c in "wax+"):
        return mode
    return None


def _calls_replace(fn) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in ("replace", "rename") \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id == "os":
            return True
    return False


class CrashOnlyIOChecker:
    id = ID

    def check(self, project: Project):
        for src in project.files:
            if not src.module_marker("persistence-root"):
                continue
            for node in ast.walk(src.tree):
                if not isinstance(node, ast.Call):
                    continue
                mode = None
                what = None
                if isinstance(node.func, ast.Name) \
                        and node.func.id == "open":
                    mode = _write_mode(node)
                    what = f"open(..., {mode!r})" if mode else None
                elif isinstance(node.func, ast.Attribute) \
                        and node.func.attr in _WRITE_METHODS:
                    what = f".{node.func.attr}(...)"
                if what is None:
                    continue
                fn = src.enclosing_function(node)
                if fn is not None and _calls_replace(fn):
                    continue  # the tmp+rename dance is local: fine
                scope = src.qualname(fn) if fn is not None else "<module>"
                yield Finding(
                    checker=self.id, file=src.rel, line=node.lineno,
                    col=node.col_offset,
                    message=(f"{what} in a persistence-root module "
                             f"without os.replace in the same function: "
                             f"use utils/vfs.py:atomic_write_bytes or "
                             f"the tmp+rename pattern"),
                    symbol=scope)
