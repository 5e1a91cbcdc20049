"""bounded-call: don't hand-roll the abandonable daemon-thread guard.

utils/bounded.py:bounded_call exists because the
spawn-thread/join-with-timeout/abandon pattern has three subtle parts
that drifted apart every time it was re-implemented (the device
watchdog, the inline-encode deadline, and the fleet join each had a
copy before they were unified): BaseException capture in the worker,
the box-before-event ordering that makes ``done.is_set()`` imply the
result is complete, and daemon-ness (a pool worker would block
interpreter exit behind a wedged C call forever).

The checker flags any function that BOTH constructs a
``threading.Thread(target=...)`` AND bounds it with ``.join(<timeout>)``
or an ``<event>.wait(<timeout>)`` — that is the guard, re-implemented.
Plain lifecycle joins (a thread created in ``start()`` and joined in
``stop()``) live in different functions and never match. utils/
bounded.py itself is the one legitimate implementation and is skipped
by path.
"""

from __future__ import annotations

import ast
import os

from parca_agent_tpu_torch.tools.lint.core import Finding, Project, SourceFile

ID = "bounded-call"

_IMPL = os.path.join("utils", "bounded.py")


def _creates_thread(fn) -> bool:
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        name = f.attr if isinstance(f, ast.Attribute) else (
            f.id if isinstance(f, ast.Name) else None)
        if name == "Thread" and any(kw.arg == "target"
                                    for kw in node.keywords):
            return True
    return False


def _bounded_wait(fn):
    """First ``x.join(timeout)`` / ``x.wait(timeout)`` call with an
    actual timeout argument, or None."""
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call) \
                or not isinstance(node.func, ast.Attribute):
            continue
        if node.func.attr not in ("join", "wait"):
            continue
        timed = bool(node.args) or any(
            kw.arg in ("timeout", "timeout_s") for kw in node.keywords)
        if timed:
            return node
    return None


class BoundedCallChecker:
    id = ID

    def check(self, project: Project):
        for src in project.files:
            if src.rel.endswith(_IMPL):
                continue  # the one legitimate implementation
            for node in ast.walk(src.tree):
                if not isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                if not _creates_thread(node):
                    continue
                wait = _bounded_wait(node)
                if wait is None:
                    continue
                yield Finding(
                    checker=self.id, file=src.rel, line=wait.lineno,
                    col=wait.col_offset,
                    message=("spawn-thread + timed join/wait "
                             "re-implements the abandonable guard: use "
                             "utils/bounded.py:bounded_call"),
                    symbol=src.qualname(node))
