"""chaos-site: the fault registry, the call sites, and the chaos tests
agree.

utils/faults.py is the single chaos layer; its ``SITES`` registry is
the contract between three parties that historically drifted apart:

  * the ``faults.inject("<site>")`` call sites in the package,
  * the registry itself (a documented site nobody injects is dead
    weight that reads as coverage),
  * the ``chaos``-marked tests that actually exercise each site.

Three rules, one checker id:

  * every ``inject()`` call site's literal must match a registry entry
    (wildcard entries like ``actor.*`` match by prefix); a non-literal
    argument cannot be audited and is flagged outright;
  * every registry entry must have at least one call site (no dead
    entries);
  * every registry entry must appear in at least one chaos-marked test
    module — matched as a substring over the module's string constants,
    which covers both ``inject("x.y")`` calls and spec-grammar strings
    like ``"x.y:error:after=5"``.

Test modules count as chaos-marked when they contain a
``@pytest.mark.chaos`` function or a module-level ``pytestmark``
mentioning ``chaos``.
"""

from __future__ import annotations

import ast

from parca_agent_tpu_torch.tools.lint.core import Finding, Project, SourceFile

ID = "chaos-site"

_FAULTS_REL = "utils/faults.py"


def _registry(project: Project) -> tuple[SourceFile | None, dict[str, int]]:
    """SITES keys -> declaration line, from the faults module."""
    faults_src = None
    for src in project.files:
        if src.rel.replace("\\", "/").endswith(_FAULTS_REL):
            faults_src = src
            break
    if faults_src is None:
        return None, {}
    sites: dict[str, int] = {}
    for node in ast.walk(faults_src.tree):
        if isinstance(node, ast.Assign) \
                and any(isinstance(t, ast.Name) and t.id == "SITES"
                        for t in node.targets) \
                and isinstance(node.value, ast.Dict):
            for k in node.value.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    sites[k.value] = k.lineno
    return faults_src, sites


def _matches(site: str, registry: dict[str, int]) -> bool:
    if site in registry:
        return True
    return any(entry.endswith("*") and site.startswith(entry[:-1])
               for entry in registry)


def _inject_sites(project: Project):
    """(src, call, site-literal-or-None) for every faults.inject() call
    in the package (the faults module itself and this lint package are
    not call sites)."""
    for src in project.files:
        rel = src.rel.replace("\\", "/")
        if rel.endswith(_FAULTS_REL) or "/tools/lint/" in rel:
            continue
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else (
                f.id if isinstance(f, ast.Name) else None)
            if name != "inject":
                continue
            site = None
            if node.args and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                site = node.args[0].value
            yield src, node, site


def _chaos_strings(project: Project) -> set[str]:
    """String constants from chaos-marked test modules that can
    actually DRIVE an injection: arguments, assignments, spec strings.
    Docstrings and other bare-expression strings are excluded — a site
    merely narrated in a test's prose must not count as exercised
    (that is exactly the drift this checker exists to catch)."""
    out: set[str] = set()
    for src in project.test_files:
        if not _is_chaos_module(src):
            continue
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Constant) and isinstance(node.value,
                                                            str):
                parent = src.parent(node)
                if isinstance(parent, ast.Expr):
                    continue  # docstring / no-op string statement
                out.add(node.value)
    return out


def _is_chaos_module(src: SourceFile) -> bool:
    for node in ast.walk(src.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                for sub in ast.walk(dec):
                    if isinstance(sub, ast.Attribute) \
                            and sub.attr == "chaos":
                        return True
        if isinstance(node, ast.Assign) \
                and any(isinstance(t, ast.Name) and t.id == "pytestmark"
                        for t in node.targets):
            for sub in ast.walk(node.value):
                if isinstance(sub, ast.Attribute) and sub.attr == "chaos":
                    return True
    return False


class ChaosSiteChecker:
    id = ID

    def check(self, project: Project):
        faults_src, registry = _registry(project)
        if faults_src is None:
            return  # no faults module in this tree (golden known-good)
        if not registry:
            yield Finding(
                checker=self.id, file=faults_src.rel, line=1, col=0,
                message=("utils/faults.py has no SITES registry: the "
                         "documented site list must be machine-readable"),
                symbol="SITES")
            return
        used: set[str] = set()
        for src, call, site in _inject_sites(project):
            fn = src.enclosing_function(call)
            scope = src.qualname(fn) if fn is not None else "<module>"
            if site is None:
                yield Finding(
                    checker=self.id, file=src.rel, line=call.lineno,
                    col=call.col_offset,
                    message=("inject() with a non-literal site cannot be "
                             "audited against the SITES registry"),
                    symbol=scope)
                continue
            used.add(site)
            if not _matches(site, registry):
                yield Finding(
                    checker=self.id, file=src.rel, line=call.lineno,
                    col=call.col_offset,
                    message=(f"inject({site!r}) is not documented in "
                             f"utils/faults.py SITES"),
                    symbol=site)
        strings = _chaos_strings(project)
        for entry, lineno in sorted(registry.items()):
            probe = entry[:-1] if entry.endswith("*") else entry
            # Liveness: prefix matching belongs to wildcard entries
            # only — a non-wildcard entry must be injected EXACTLY
            # (inject("device.probe2") must not keep "device.probe"
            # looking alive).
            if entry.endswith("*"):
                live = any(u.startswith(probe) for u in used)
            else:
                live = entry in used
            if not live:
                yield Finding(
                    checker=self.id, file=faults_src.rel, line=lineno,
                    col=0,
                    message=(f"SITES entry {entry!r} has no inject() "
                             f"call site: dead registry entry"),
                    symbol=entry)
            if not any(probe in s for s in strings):
                yield Finding(
                    checker=self.id, file=faults_src.rel, line=lineno,
                    col=0,
                    message=(f"SITES entry {entry!r} is not exercised by "
                             f"any chaos-marked test"),
                    symbol=entry)
