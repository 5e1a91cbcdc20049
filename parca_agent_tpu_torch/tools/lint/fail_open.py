"""fail-open-hook: registered hooks must swallow-and-count, never raise.

The agent's "degrade, never die" contract hangs callbacks off its hot
loops: encode-pipeline snapshot/rollup hooks run on the worker that
ships every window, supervisor probes run on the poll loop that keeps
crashed actors restarting, flight-recorder entry points run inside the
capture iteration itself. An exception escaping any of them turns a
bookkeeping bug into a lost window (or a dead supervisor). The shape
the contract requires — and this checker enforces — is the counted
try/except:

    def hook(...):
        '''...'''
        try:
            ...the whole body...
        except Exception:
            self.stats["hook_errors"] += 1   # counted, and
            ...                              # nothing re-raises

Checked functions are found two ways:

  * annotation: ``# palint: fail-open`` on the def line declares the
    contract explicitly (the flight-recorder entry points);
  * registration: callables passed as ``snapshot=`` / ``rollup=`` /
    ``rollup_capture=`` to an ``EncodePipeline(...)`` call, or as
    ``check=`` / ``revive=`` to ``add_probe(...)``. References resolve
    by name (``self._hook`` -> the enclosing class's method, ``x.save``
    -> every project def named ``save``); a lambda passes only when its
    body contains no calls (attribute reads cannot realistically raise)
    or is a single call to a function that itself passes.

Shape rules: after the docstring and simple constant/local assignments,
the body must be a single ``try`` whose handler set includes a broad
catch (``Exception``/``BaseException``/bare), contains no ``raise``,
and does *something* observable (an ``x += 1`` style count or a call —
a silent ``pass`` hides the failure instead of containing it). ``else:``
blocks are rejected — they run outside the handler's protection. A
trailing ``return`` of a local/constant is allowed.
"""

from __future__ import annotations

import ast

from parca_agent_tpu_torch.tools.lint.core import Finding, Project, SourceFile

ID = "fail-open-hook"

# call-name -> kwargs that register fail-open hooks. add_probe also
# accepts check/revive positionally (args[1], args[2] after the name).
_REGISTRATIONS = {
    "EncodePipeline": ("snapshot", "rollup", "rollup_capture"),
    "add_probe": ("check", "revive"),
}


def _call_name(call: ast.Call) -> str | None:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def _broad_handler(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    names = [t] if not isinstance(t, ast.Tuple) else list(t.elts)
    for n in names:
        if isinstance(n, ast.Name) and n.id in ("Exception",
                                                "BaseException"):
            return True
        if isinstance(n, ast.Attribute) and n.attr in ("Exception",
                                                       "BaseException"):
            return True
    return False


def _contains_raise(stmts) -> bool:
    stack = list(stmts)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue  # a nested def's raise fires on ITS caller
        if isinstance(node, ast.Raise):
            return True
        stack.extend(ast.iter_child_nodes(node))
    return False


def _counts_something(stmts) -> bool:
    for stmt in stmts:
        for node in ast.walk(stmt):
            if isinstance(node, (ast.AugAssign, ast.Call)):
                return True
            if isinstance(node, ast.Assign):
                return True
    return False


def _is_simple_setup(stmt: ast.stmt) -> bool:
    """Pre-try statements that cannot realistically raise: docstrings,
    assignments of constants/names/attribute reads, and imports of
    core dependencies (a missing core dep fails the first window, not
    just the hook — fail-open cannot help there)."""
    if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Constant):
        return True
    if isinstance(stmt, (ast.Import, ast.ImportFrom)):
        return True
    if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
        value = stmt.value
        return value is None or not any(
            isinstance(n, ast.Call) for n in ast.walk(value))
    return False


def _is_simple_return(stmt: ast.stmt) -> bool:
    if not isinstance(stmt, ast.Return):
        return False
    v = stmt.value
    return v is None or not any(isinstance(n, ast.Call)
                                for n in ast.walk(v))


def check_shape(fn) -> str | None:
    """None when the function satisfies the fail-open shape, else a
    human-readable reason."""
    body = list(fn.body)
    while body and _is_simple_setup(body[0]):
        body.pop(0)
    while body and _is_simple_return(body[-1]):
        body.pop()
    if len(body) != 1 or not isinstance(body[0], ast.Try):
        return ("body is not a single counted try/except "
                "(statements outside the try can raise out of the hook)")
    tr = body[0]
    if tr.orelse:
        return "try has an else: block, which runs unprotected"
    if tr.finalbody:
        return ("try has a finally: block, which runs unprotected (a "
                "raising cleanup escapes the hook)")
    if not any(_broad_handler(h) for h in tr.handlers):
        return ("no broad except handler (Exception/BaseException): "
                "unlisted exception classes escape")
    for h in tr.handlers:
        if _contains_raise(h.body):
            return "except handler re-raises"
        if _broad_handler(h) and not _counts_something(h.body):
            return ("broad handler swallows silently: count or log the "
                    "failure")
    return None


class _Resolver:
    """Name-based callable resolution across the project. Deliberately
    loose: a project this size has essentially unique method names, and
    the golden tests in tests/test_lint.py pin the semantics."""

    def __init__(self, project: Project):
        self.project = project
        self._defs: dict[str, list[tuple[SourceFile, ast.AST]]] = {}
        for src in project.files:
            for node in ast.walk(src.tree):
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    self._defs.setdefault(node.name, []).append(
                        (src, node))

    def by_name(self, name: str, prefer_class: ast.ClassDef | None = None,
                src: SourceFile | None = None):
        """Candidates for a reference, narrowest scope that matches:
        the preferred class (``self.m``), then the same file, then the
        whole project — but a project-wide fan-out over a common name
        audits unrelated defs, so it is capped: past 4 candidates the
        reference is treated as unresolvable."""
        cands = self._defs.get(name, [])
        if prefer_class is not None and src is not None:
            scoped = [(s, n) for s, n in cands
                      if s is src and s.enclosing_class(n) is prefer_class]
            if scoped:
                return scoped
        if src is not None:
            local = [(s, n) for s, n in cands if s is src]
            if local:
                return local
        return cands if len(cands) <= 4 else []


class FailOpenChecker:
    id = ID

    def check(self, project: Project):
        resolver = _Resolver(project)
        seen: set[int] = set()
        # 1) explicitly annotated functions
        for src in project.files:
            for node in ast.walk(src.tree):
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)) \
                        and src.def_marker(node, "fail-open"):
                    yield from self._check_def(src, node, seen,
                                               "annotated fail-open")
        # 2) hook registrations
        for src in project.files:
            for node in ast.walk(src.tree):
                if not isinstance(node, ast.Call):
                    continue
                name = _call_name(node)
                kwargs = _REGISTRATIONS.get(name or "")
                if not kwargs:
                    continue
                for kw in node.keywords:
                    if kw.arg in kwargs:
                        yield from self._check_ref(
                            src, node, kw.value, resolver, seen,
                            f"registered via {name}({kw.arg}=...)")
                if name == "add_probe":
                    for pos in node.args[1:3]:
                        yield from self._check_ref(
                            src, node, pos, resolver, seen,
                            "registered via add_probe(...)")

    # -- helpers -------------------------------------------------------------

    def _check_def(self, src: SourceFile, fn, seen: set[int], why: str):
        if id(fn) in seen:
            return
        seen.add(id(fn))
        if src.def_marker_value(fn, "fail-open") == "caller":
            # Documented disposition: containment lives at the
            # registered invocation site (the pipeline's counted hook
            # guard, the supervisor's probe guard) and the hook's own
            # raise is part of its metrics contract — e.g. the hotspot
            # fold counts fold_errors and re-raises for the worker to
            # count rollup_errors. The annotation is the audit trail.
            return
        reason = check_shape(fn)
        if reason is not None:
            yield Finding(
                checker=self.id, file=src.rel, line=fn.lineno,
                col=fn.col_offset,
                message=f"{fn.name} must be fail-open ({why}): {reason}",
                symbol=src.qualname(fn))

    def _check_ref(self, src: SourceFile, call: ast.Call, ref,
                   resolver: _Resolver, seen: set[int], why: str,
                   depth: int = 0):
        if depth > 3:
            return
        # Conditional registrations: X if cond else None
        if isinstance(ref, ast.IfExp):
            for branch in (ref.body, ref.orelse):
                yield from self._check_ref(src, call, branch, resolver,
                                           seen, why, depth + 1)
            return
        if isinstance(ref, ast.Constant) and ref.value is None:
            return
        if isinstance(ref, ast.Lambda):
            calls = [n for n in ast.walk(ref.body)
                     if isinstance(n, ast.Call)]
            if not calls:
                return  # attribute/comparison lambdas cannot raise
            if len(calls) == 1 and calls[0] is ref.body:
                yield from self._check_ref(src, call, ref.body.func,
                                           resolver, seen, why, depth + 1)
                return
            yield Finding(
                checker=self.id, file=src.rel, line=ref.lineno,
                col=ref.col_offset,
                message=(f"lambda {why} makes calls and cannot contain "
                         f"a try/except: register a fail-open def "
                         f"instead"),
                symbol=(src.qualname(src.enclosing_function(call))
                        if src.enclosing_function(call) else "<module>")
                + ":lambda")
            return
        if isinstance(ref, ast.Name):
            # A plain name: prefer the local binding in the registering
            # function (the ``snapshot = lambda ...`` idiom), else a
            # module-level def in this file. A bare name never resolves
            # project-wide — that would audit unrelated same-named defs.
            local = self._local_binding(src, call, ref.id)
            if local is not None:
                yield from self._check_ref(src, call, local, resolver,
                                           seen, why, depth + 1)
                return
            for dsrc, dfn in resolver.by_name(ref.id, None, src):
                if dsrc is src and dsrc.enclosing_class(dfn) is None:
                    yield from self._check_def(dsrc, dfn, seen, why)
            return
        if isinstance(ref, ast.Attribute):
            prefer = None
            if isinstance(ref.value, ast.Name) and ref.value.id == "self":
                prefer = src.enclosing_class(call)
            for dsrc, dfn in resolver.by_name(ref.attr, prefer, src):
                yield from self._check_def(dsrc, dfn, seen, why)

    @staticmethod
    def _local_binding(src: SourceFile, call: ast.Call, name: str):
        """The value last assigned to ``name`` in the function that
        makes the registration call, textually before the call."""
        fn = src.enclosing_function(call)
        if fn is None:
            return None
        best = None
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and node.lineno < call.lineno \
                    and any(isinstance(t, ast.Name) and t.id == name
                            for t in node.targets):
                if best is None or node.lineno > best.lineno:
                    best = node
        return best.value if best is not None else None
