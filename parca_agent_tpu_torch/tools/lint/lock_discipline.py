"""lock-discipline: guarded attributes only under their guarding lock.

The defect class this kills: a stats field mutated from two threads
where one path grew a ``with self._lock`` and the other didn't (the
GRPCStoreClient consec-unavailable counter, the trace recorder's
two-writer lost-update, the batch client's flush-thread stats). The
contract is declared next to the data, not in the reviewer's head:

    self._consec_unavailable = 0   # guarded-by: _stats_lock

or, for classes with many guarded fields, a class-level map::

    _GUARDED = {"_consec_unavailable": "_stats_lock",
                "stats": "_stats_lock"}

Every ``self.<attr>`` read/write of a guarded attribute must then sit
lexically inside ``with self.<lock>`` in that class. ``__init__`` (and
``__new__``) are exempt — construction happens before the object is
shared. A helper documented to run with the lock already held is
annotated ``# palint: holds=<lock>`` on its def line; palint trusts the
annotation for the body and leaves the call-sites to the with-block
rule.
"""

from __future__ import annotations

import ast

from parca_agent_tpu_torch.tools.lint.core import Finding, Project, SourceFile

ID = "lock-discipline"

# Construction/destruction scopes where the object is not yet (or no
# longer) shared between threads.
_EXEMPT_METHODS = {"__init__", "__new__", "__del__"}


def _guarded_map(src: SourceFile, cls: ast.ClassDef) -> dict[str, str]:
    """attr -> lock-attr for one class, from ``# guarded-by:`` comments
    on ``self.x = ...`` lines and the optional ``_GUARDED`` class map."""
    guarded: dict[str, str] = {}
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and src.enclosing_class(node) is cls:
            # _GUARDED = {"attr": "_lock", ...} in the class body
            if (len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id == "_GUARDED"
                    and isinstance(node.value, ast.Dict)):
                for k, v in zip(node.value.keys, node.value.values):
                    if (isinstance(k, ast.Constant)
                            and isinstance(k.value, str)
                            and isinstance(v, ast.Constant)
                            and isinstance(v.value, str)):
                        guarded[k.value] = v.value
                continue
            for tgt in node.targets:
                _note_guarded_target(src, tgt, node, guarded)
        elif isinstance(node, ast.AnnAssign) \
                and src.enclosing_class(node) is cls:
            _note_guarded_target(src, node.target, node, guarded)
    return guarded


def _note_guarded_target(src: SourceFile, tgt: ast.AST, stmt: ast.stmt,
                         guarded: dict[str, str]) -> None:
    if not (isinstance(tgt, ast.Attribute)
            and isinstance(tgt.value, ast.Name)
            and tgt.value.id == "self"):
        return
    for ln in range(stmt.lineno, (stmt.end_lineno or stmt.lineno) + 1):
        lock = src.guarded_by(ln)
        if lock:
            guarded[tgt.attr] = lock
            return


def _with_locks(node: ast.With) -> set[str]:
    """Lock attribute names acquired by one ``with`` statement:
    ``with self._lock:`` / ``with self._cond:`` (Condition's context
    manager IS its lock)."""
    out = set()
    for item in node.items:
        e = item.context_expr
        if (isinstance(e, ast.Attribute) and isinstance(e.value, ast.Name)
                and e.value.id == "self"):
            out.add(e.attr)
    return out


class LockDisciplineChecker:
    id = ID

    def check(self, project: Project):
        for src in project.files:
            for node in ast.walk(src.tree):
                if isinstance(node, ast.ClassDef):
                    yield from self._check_class(src, node)

    def _check_class(self, src: SourceFile, cls: ast.ClassDef):
        guarded = _guarded_map(src, cls)
        if not guarded:
            return
        for meth in cls.body:
            if not isinstance(meth, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            if meth.name in _EXEMPT_METHODS:
                continue
            held = set(src.def_holds(meth))
            yield from self._walk(src, cls, meth, meth.body,
                                  guarded, held)

    def _walk(self, src: SourceFile, cls: ast.ClassDef, meth, stmts,
              guarded: dict[str, str], held: set[str]):
        """Statement walk threading the set of currently-held locks;
        lexical containment is the model (a closure defined under the
        lock but called later is out of scope — and out of idiom)."""
        for stmt in stmts:
            if isinstance(stmt, ast.With):
                inner = held | _with_locks(stmt)
                for item in stmt.items:
                    yield from self._scan_expr(src, cls, meth,
                                               item.context_expr,
                                               guarded, held)
                yield from self._walk(src, cls, meth, stmt.body,
                                      guarded, inner)
                continue
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # Nested def: annotations restart; its body is checked
                # as running without the enclosing locks (it usually
                # does — worker targets, deferred callbacks).
                nested = set(src.def_holds(stmt))
                yield from self._walk(src, cls, meth, stmt.body,
                                      guarded, nested)
                continue
            for field, value in ast.iter_fields(stmt):
                if field in ("body", "orelse", "finalbody", "handlers"):
                    blocks = value if isinstance(value, list) else [value]
                    for b in blocks:
                        if isinstance(b, ast.excepthandler):
                            yield from self._walk(src, cls, meth, b.body,
                                                  guarded, held)
                        elif isinstance(b, ast.stmt):
                            yield from self._walk(src, cls, meth, [b],
                                                  guarded, held)
                        elif isinstance(b, list):
                            yield from self._walk(src, cls, meth, b,
                                                  guarded, held)
                        elif isinstance(b, ast.expr):
                            yield from self._scan_expr(src, cls, meth, b,
                                                       guarded, held)
                elif isinstance(value, list):
                    for v in value:
                        if isinstance(v, ast.stmt):
                            yield from self._walk(src, cls, meth, [v],
                                                  guarded, held)
                        elif isinstance(v, ast.expr):
                            yield from self._scan_expr(src, cls, meth, v,
                                                       guarded, held)
                elif isinstance(value, ast.stmt):
                    yield from self._walk(src, cls, meth, [value],
                                          guarded, held)
                elif isinstance(value, ast.expr):
                    yield from self._scan_expr(src, cls, meth, value,
                                               guarded, held)

    def _scan_expr(self, src: SourceFile, cls: ast.ClassDef, meth, expr,
                   guarded: dict[str, str], held: set[str]):
        stack = [expr]
        while stack:
            node = stack.pop()
            if isinstance(node, ast.Lambda):
                # Deferred execution: the lambda runs later, without the
                # lexically-enclosing locks. Its body is checked as
                # lock-free.
                yield from self._scan_expr(src, cls, meth, node.body,
                                           guarded, set())
                continue
            stack.extend(ast.iter_child_nodes(node))
            if (isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "self"
                    and node.attr in guarded
                    and guarded[node.attr] not in held):
                yield Finding(
                    checker=self.id, file=src.rel, line=node.lineno,
                    col=node.col_offset,
                    message=(f"self.{node.attr} is guarded-by "
                             f"self.{guarded[node.attr]} but accessed "
                             f"outside it"),
                    symbol=f"{cls.name}.{meth.name}:{node.attr}")
