"""palint core: source model, annotation grammar, suppressions, baseline.

The model is deliberately plain: one :class:`SourceFile` per parsed file
(AST + the comment table ``ast`` drops, recovered via ``tokenize``), one
:class:`Project` over the package (plus the port's test modules, which
only the chaos-site checker reads), and a :class:`Finding` stream the
runner filters through inline suppressions and the committed baseline.

Annotation grammar (docs/static-analysis.md):

    # guarded-by: _lock            this attribute is owned by self._lock
    # palint: holds=_lock          this function is documented to be
                                   called with self._lock already held
    # palint: fail-open            this function promises the counted
                                   try/except fail-open shape
    # palint: capture-path         host-sync seed: this function runs on
                                   the capture thread's dispatch path
    # palint: sync-ok -- <why>     documented deliberate sync boundary;
                                   the host-sync walk stops here
    # palint: persistence-root     module marker: write-mode opens here
                                   must be tmp+os.replace atomic
    # palint: device-state: _a,_b  module marker: attributes holding
                                   device-resident arrays (host-sync)
    # palint: disable=<id>[,<id>] -- <why>
                                   suppress findings on this line
"""

from __future__ import annotations

import ast
import dataclasses
import io
import json
import os
import re
import tokenize

_DISABLE_RE = re.compile(r"palint:\s*disable=([\w\-]+(?:\s*,\s*[\w\-]+)*)")
_GUARDED_RE = re.compile(r"guarded-by:\s*([\w.]+)")
_HOLDS_RE = re.compile(r"palint:\s*holds=([\w.]+)")
_MARKER_RE = re.compile(r"palint:\s*([\w\-]+)(?:=([\w.\-]+))?")
_DEVICE_STATE_RE = re.compile(r"palint:\s*device-state:\s*([\w, ]+)")


@dataclasses.dataclass(frozen=True)
class Finding:
    checker: str
    file: str          # project-relative path
    line: int
    col: int
    message: str
    symbol: str        # stable scope key for baseline matching

    def key(self) -> str:
        """Baseline identity: line numbers churn with every edit, the
        (checker, file, symbol) scope does not — so a baselined finding
        stays baselined across unrelated diffs but a NEW finding in the
        same file still gates."""
        return f"{self.checker}::{self.file}::{self.symbol}"

    def render(self) -> str:
        return (f"{self.file}:{self.line}:{self.col}: "
                f"[{self.checker}] {self.message} ({self.symbol})")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class SourceFile:
    def __init__(self, path: str, rel: str, text: str):
        self.path = path
        self.rel = rel
        self.text = text
        self.tree = ast.parse(text, filename=rel)
        self.comments: dict[int, str] = {}
        try:
            for tok in tokenize.generate_tokens(
                    io.StringIO(text).readline):
                if tok.type == tokenize.COMMENT:
                    self.comments[tok.start[0]] = tok.string
        except tokenize.TokenError:  # pragma: no cover - parse succeeded
            pass
        self._parents: dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self._parents[child] = parent

    # -- comment annotations -------------------------------------------------

    def disables(self, line: int) -> set[str]:
        m = _DISABLE_RE.search(self.comments.get(line, ""))
        if not m:
            return set()
        return {s.strip() for s in m.group(1).split(",") if s.strip()}

    def guarded_by(self, line: int) -> str | None:
        m = _GUARDED_RE.search(self.comments.get(line, ""))
        return m.group(1) if m else None

    def _def_comment_lines(self, node: ast.AST) -> list[int]:
        """Lines where a def-level annotation may sit: the def line(s)
        through the first body statement's predecessor, plus one
        comment-only line above the def/decorators."""
        first = getattr(node, "body", None)
        end = first[0].lineno - 1 if first else node.lineno
        start = node.lineno
        for dec in getattr(node, "decorator_list", ()):
            start = min(start, dec.lineno)
        lines = list(range(start, max(end, node.lineno) + 1))
        # ... plus the contiguous comment block directly above the def —
        # multi-line annotations put the marker on their first line.
        ln = start - 1
        while ln in self.comments:
            lines.append(ln)
            ln -= 1
        return lines

    def def_marker(self, node: ast.AST, name: str) -> bool:
        for ln in self._def_comment_lines(node):
            for m in _MARKER_RE.finditer(self.comments.get(ln, "")):
                if m.group(1) == name:
                    return True
        return False

    def def_marker_value(self, node: ast.AST, name: str) -> str | None:
        """The ``=value`` of a def-line marker (``# palint:
        fail-open=caller`` -> ``"caller"``); empty string for a bare
        marker, None when absent."""
        for ln in self._def_comment_lines(node):
            for m in _MARKER_RE.finditer(self.comments.get(ln, "")):
                if m.group(1) == name:
                    return m.group(2) or ""
        return None

    def def_holds(self, node: ast.AST) -> set[str]:
        held: set[str] = set()
        for ln in self._def_comment_lines(node):
            m = _HOLDS_RE.search(self.comments.get(ln, ""))
            if m:
                held.add(m.group(1))
        return held

    def module_marker(self, name: str) -> bool:
        for text in self.comments.values():
            for m in _MARKER_RE.finditer(text):
                if m.group(1) == name:
                    return True
        return False

    def device_state_attrs(self) -> set[str]:
        attrs: set[str] = set()
        for text in self.comments.values():
            m = _DEVICE_STATE_RE.search(text)
            if m:
                attrs |= {s.strip() for s in m.group(1).split(",")
                          if s.strip()}
        return attrs

    # -- tree helpers --------------------------------------------------------

    def parent(self, node: ast.AST) -> ast.AST | None:
        return self._parents.get(node)

    def enclosing_function(self, node: ast.AST):
        n = self.parent(node)
        while n is not None:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return n
            n = self.parent(n)
        return None

    def enclosing_class(self, node: ast.AST) -> ast.ClassDef | None:
        n = self.parent(node)
        while n is not None:
            if isinstance(n, ast.ClassDef):
                return n
            n = self.parent(n)
        return None

    def qualname(self, node: ast.AST) -> str:
        """Dotted scope path for a def/class node (symbol keys)."""
        parts = []
        n = node
        while n is not None and not isinstance(n, ast.Module):
            name = getattr(n, "name", None)
            if name is not None:
                parts.append(name)
            n = self.parent(n)
        return ".".join(reversed(parts)) or "<module>"


class Project:
    """The linted tree: every parsable .py under the package dir, plus
    the port's test modules (consulted only for chaos-marker coverage —
    tests are never themselves linted)."""

    def __init__(self, files: list[SourceFile],
                 test_files: list[SourceFile] | None = None):
        self.files = files
        self.test_files = test_files or []
        self.by_rel = {f.rel: f for f in files}

    @classmethod
    def load(cls, root: str, package: str = "parca_agent_tpu_torch",
             tests: str = "tests") -> "Project":
        files = cls._scan(root, os.path.join(root, package))
        test_dir = os.path.join(root, tests)
        test_files = (port_test_files(root, test_dir)
                      if os.path.isdir(test_dir) else [])
        return cls(files, test_files)

    @staticmethod
    def _scan(root: str, top: str) -> list[SourceFile]:
        out = []
        for dirpath, dirnames, filenames in os.walk(top):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in ("__pycache__",))
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                path = os.path.join(dirpath, fn)
                rel = os.path.relpath(path, root)
                try:
                    with open(path, encoding="utf-8") as f:
                        text = f.read()
                    out.append(SourceFile(path, rel, text))
                except (OSError, SyntaxError, ValueError) as e:
                    # A file the checker cannot parse is a finding-shaped
                    # problem in itself, but the tier-1 suite owns syntax;
                    # palint just skips it loudly via stderr in the CLI.
                    import sys

                    print(f"palint: skipping unparsable {rel}: {e}",
                          file=sys.stderr)
        return out


_PORT_TESTS = re.compile(r"^test_torch_\w*\.py$")


def port_test_files(root: str, test_dir: str) -> list[SourceFile]:
    """The port's test modules: ``test_torch_*.py`` under ``test_dir``,
    and each original test module one of them runs through the port
    (``port_cases("<name>", ...)`` with a literal name, whose cases run
    under the caller's file). The original suite's other modules name
    the same chaos sites but exercise parca_agent_tpu, so they are not
    the port's coverage."""
    def parse(path):
        with open(path, encoding="utf-8") as fp:
            return SourceFile(path, os.path.relpath(path, root), fp.read())

    own = [parse(os.path.join(test_dir, fn))
           for fn in sorted(os.listdir(test_dir)) if _PORT_TESTS.match(fn)]
    ran: set[str] = set()
    for src in own:
        for node in ast.walk(src.tree):
            f = node.func if isinstance(node, ast.Call) else None
            name = f.attr if isinstance(f, ast.Attribute) else (
                f.id if isinstance(f, ast.Name) else None)
            if name == "port_cases" and node.args \
                    and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                ran.add(node.args[0].value)
    extra = [parse(os.path.join(test_dir, f"{name}.py"))
             for name in sorted(ran)
             if os.path.isfile(os.path.join(test_dir, f"{name}.py"))]
    return own + extra


# -- runner ------------------------------------------------------------------

def run_checkers(project: Project, checkers) -> tuple[list[Finding], int]:
    """Run every checker; returns (findings, suppressed_count) with
    inline ``# palint: disable=`` suppressions already applied. A
    suppression comment may sit on any line the finding's statement
    spans (multi-line calls put the comment where black/PEP8 leaves
    room)."""
    findings: list[Finding] = []
    suppressed = 0
    for checker in checkers:
        for f in checker.check(project):
            src = project.by_rel.get(f.file)
            if src is not None and _is_suppressed(src, f):
                suppressed += 1
                continue
            findings.append(f)
    findings.sort(key=lambda f: (f.file, f.line, f.checker))
    return findings, suppressed


def _is_suppressed(src: SourceFile, f: Finding) -> bool:
    lines = {f.line, f.line - 1}
    lines.update(_statement_span(src, f.line))
    for ln in lines:
        ids = src.disables(ln)
        if f.checker in ids or "all" in ids:
            return True
    return False


def _statement_span(src: SourceFile, line: int) -> range:
    """Physical lines of the innermost statement covering ``line`` — a
    multi-line call anchors its finding at the first line while the
    only room for a comment may be the last. Compound statements
    (def/if/with/try...) count only as far as their HEADER: a disable
    deep inside a body must not suppress a finding anchored at the
    header, but the closing line of a multi-line ``with open(...)``
    must."""
    best = None
    for node in ast.walk(src.tree):
        if not isinstance(node, ast.stmt):
            continue
        body = getattr(node, "body", None)
        if isinstance(body, list) and body:
            end = body[0].lineno - 1  # header only
        else:
            end = node.end_lineno or node.lineno
        if node.lineno <= line <= end:
            if best is None or (node.lineno, -end) > (best[0], -best[1]):
                best = (node.lineno, end)
    if best is None:
        return range(line, line + 1)
    return range(best[0], best[1] + 1)


# -- baseline ----------------------------------------------------------------

def load_baseline(path: str) -> dict[str, int]:
    """baseline.json: ``{"findings": [{"checker","file","symbol",
    "count","why"}]}``. Counts gate on growth: N baselined findings in a
    scope allow N, the N+1st gates."""
    with open(path, encoding="utf-8") as fp:
        data = json.load(fp)
    out: dict[str, int] = {}
    for e in data.get("findings", []):
        key = f"{e['checker']}::{e['file']}::{e['symbol']}"
        out[key] = out.get(key, 0) + int(e.get("count", 1))
    return out


def apply_baseline(findings: list[Finding], baseline: dict[str, int]
                   ) -> tuple[list[Finding], int, list[str]]:
    """Split findings into (new, baselined_count, stale_keys). Stale =
    a baseline entry whose findings no longer exist (or exist fewer
    times than baselined): reported so the baseline shrinks with the
    fixes instead of silently fossilizing."""
    budget = dict(baseline)
    new: list[Finding] = []
    baselined = 0
    for f in findings:
        k = f.key()
        if budget.get(k, 0) > 0:
            budget[k] -= 1
            baselined += 1
        else:
            new.append(f)
    stale = sorted(k for k, n in budget.items() if n > 0)
    return new, baselined, stale


def write_baseline(path: str, findings: list[Finding],
                   keep: list[dict] | None = None) -> None:
    """Rewrite the baseline from the current findings; ``keep`` carries
    entries to preserve verbatim (a partial ``--checker`` run must not
    delete the other checkers' deliberate baselines)."""
    from parca_agent_tpu_torch.utils.vfs import atomic_write_bytes

    entries = list(keep or []) + [
        {"checker": f.checker, "file": f.file, "symbol": f.symbol,
         "count": 1, "why": "TODO: justify or fix"}
        for f in findings
    ]
    entries.sort(key=lambda e: (e.get("checker", ""), e.get("file", ""),
                                e.get("symbol", "")))
    body = json.dumps({"findings": entries}, indent=2, sort_keys=True)
    atomic_write_bytes(path, (body + "\n").encode())
