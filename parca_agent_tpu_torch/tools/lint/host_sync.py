"""host-sync: no blocking device fetches on the capture path.

The capture thread pays DISPATCH only: the feed kernel's miss check is
deferred to the next drain, the close is split into dispatch/collect,
and the sync points left (``_settle_misses``, the uploads) are
documented boundaries. A host sync creeping back into this path (a
``.item()``/``.cpu()`` on a CUDA tensor, ``torch.cuda.synchronize()``,
an ``np.asarray`` over a device tensor) silently re-serializes capture
against the card and undoes the overlap — and, outside the device
watchdog's ``device_wait`` (utils/bounded.py), a wedged card there would
hang the capture thread unbounded. A benchmark would catch the
regression eventually; this checker catches the diff.

Seeds are annotated at the def::

    # palint: capture-path
    def feed(self, ...):

The checker walks the project call graph from every seed (``self.m()``
resolves within the class, bare names within the module, ``x.m()``
within the file) and flags, in every reachable function:

  * ``.item()``, ``.cpu()``, ``.synchronize()`` (``torch.cuda.
    synchronize()``, a stream's or an event's), and the original's
    ``jax.device_get(...)`` and ``.block_until_ready()``;
  * ``.tolist()`` / ``.numpy()`` on device state, and ``np.asarray`` /
    ``np.array`` / ``float()`` / ``int()`` whose argument mentions
    device state — an attribute or name listed in the module's
    ``# palint: device-state: _acc, _touch, ...`` annotation, or a
    local assigned from a ``torch.*`` (or ``jnp.*``) call or from other
    device values.

Two shapes are exempt. A call inside a ``with device_wait():`` block is
a host wait the device watchdog bounds (the block is its documentation),
and the functions called from inside such a block are not walked. A
function that must sync by design (a deferred settle, a collect)
carries ``# palint: sync-ok -- <why>`` on its def line: the walk stops
there and its body is exempt — the annotation is the documentation.
Uploads (``torch.as_tensor``, ``.to(device)``, ``jnp.asarray``) are not
fetches and never flagged.
"""

from __future__ import annotations

import ast

from parca_agent_tpu_torch.tools.lint.core import (
    _DEVICE_STATE_RE,
    Finding,
    Project,
    SourceFile,
)

ID = "host-sync"

_NP_NAMES = ("np", "numpy", "onp")
_NP_SYNCS = ("asarray", "array")


def _device_names(src: SourceFile, fn) -> set[str]:
    """Names/attrs in ``fn`` holding device-resident values: the
    module's declared device-state attributes plus locals assigned from
    ``jnp.*`` calls or from other device values (flow-insensitive
    fixpoint — two passes cover realistic chains)."""
    declared = src.device_state_attrs()
    names = set(declared)
    for _ in range(2):
        grew = False
        for node in ast.walk(fn):
            if not isinstance(node, ast.Assign):
                continue
            if not _mentions_device(node.value, names):
                continue
            for tgt in node.targets:
                for sub in ast.walk(tgt):
                    if isinstance(sub, ast.Name) and sub.id not in names:
                        names.add(sub.id)
                        grew = True
        if not grew:
            break
    return names


# Module names whose calls produce device values.
_DEVICE_MODULES = ("jnp", "torch")


def _mentions_device(expr, names: set[str]) -> bool:
    for node in ast.walk(expr):
        if isinstance(node, ast.Attribute) and node.attr in names:
            return True
        if isinstance(node, ast.Name) and node.id in names:
            return True
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id in _DEVICE_MODULES:
            return True
    return False


def _sync_reason(node: ast.Call, device: set[str]) -> str | None:
    f = node.func
    if isinstance(f, ast.Attribute):
        bare = not node.args and not node.keywords
        if f.attr == "block_until_ready":
            return ".block_until_ready() blocks on the device"
        if f.attr == "item" and bare:
            return ".item() is a blocking device fetch"
        if f.attr == "cpu" and bare:
            return ".cpu() is a blocking device fetch"
        if f.attr == "synchronize":
            return f"{_dotted(f)}() blocks on the device"
        if f.attr in ("tolist", "numpy") and bare \
                and _mentions_device(f.value, device):
            return (f".{f.attr}() over device state is a blocking device "
                    f"fetch")
        if f.attr == "device_get":
            return "jax.device_get is a blocking device fetch"
        if f.attr in _NP_SYNCS and isinstance(f.value, ast.Name) \
                and f.value.id in _NP_NAMES \
                and node.args and _mentions_device(node.args[0], device):
            return (f"np.{f.attr}() over device state materializes on "
                    f"the host (blocking fetch)")
    if isinstance(f, ast.Name) and f.id in ("float", "int") \
            and node.args and _mentions_device(node.args[0], device):
        return f"{f.id}() over device state is a blocking device fetch"
    return None


def _dotted(node) -> str:
    """``torch.cuda.synchronize`` for an Attribute chain (the last part
    alone past a call or subscript)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _is_device_wait(stmt) -> bool:
    """``with device_wait():`` (or ``bounded.device_wait()``)."""
    if not isinstance(stmt, (ast.With, ast.AsyncWith)):
        return False
    for item in stmt.items:
        e = item.context_expr
        if isinstance(e, ast.Call):
            f = e.func
            name = f.attr if isinstance(f, ast.Attribute) else (
                f.id if isinstance(f, ast.Name) else None)
            if name == "device_wait":
                return True
    return False


def _bounded_nodes(fn) -> set[int]:
    """ids of every node inside a ``with device_wait():`` block of
    ``fn`` (its body: the host waits the device watchdog bounds)."""
    out: set[int] = set()
    for node in ast.walk(fn):
        if _is_device_wait(node):
            for stmt in node.body:
                out.update(id(n) for n in ast.walk(stmt))
    return out


class _Graph:
    def __init__(self, project: Project):
        self.project = project
        # (file-rel, qualname) -> (src, fn)
        self.nodes: dict[tuple[str, str], tuple[SourceFile, ast.AST]] = {}
        for src in project.files:
            for node in ast.walk(src.tree):
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    self.nodes[(src.rel, src.qualname(node))] = (src, node)

    def callees(self, src: SourceFile, fn):
        """Resolve calls made by ``fn`` to project defs, same-file
        scope: self.m() -> the class's m, bare m() -> module-level m,
        x.m() -> any def named m in this file (loose, and good enough
        for the package's intra-module helper idiom)."""
        cls = src.enclosing_class(fn)
        bounded = _bounded_nodes(fn)
        out = []
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call) or id(node) in bounded:
                continue
            f = node.func
            if isinstance(f, ast.Attribute):
                name = f.attr
                prefer_cls = (cls if isinstance(f.value, ast.Name)
                              and f.value.id == "self" else None)
            elif isinstance(f, ast.Name):
                name = f.id
                prefer_cls = None
            else:
                continue
            for (rel, qual), (dsrc, dfn) in self.nodes.items():
                if rel != src.rel or dfn.name != name:
                    continue
                dcls = dsrc.enclosing_class(dfn)
                if prefer_cls is not None and dcls is not prefer_cls:
                    continue
                if prefer_cls is None and isinstance(f, ast.Name) \
                        and dcls is not None:
                    continue  # bare name cannot be a method
                out.append((dsrc, dfn))
        return out


class HostSyncChecker:
    id = ID

    def check(self, project: Project):
        # A device-state marker that parses to nothing — or whose list
        # was wrapped onto a comment continuation line (the grammar
        # deliberately does not parse those, so the tail attrs would be
        # silently dropped) — is a defanged invariant: flag it rather
        # than lint green with a truncated attr set.
        for src in project.files:
            for ln, text in sorted(src.comments.items()):
                if "palint" not in text or "device-state" not in text:
                    continue
                m = _DEVICE_STATE_RE.search(text)
                if m is None or m.group(1).rstrip().endswith(","):
                    yield Finding(
                        checker=self.id, file=src.rel, line=ln, col=0,
                        message=("device-state annotation parses to no "
                                 "(or a truncated) attribute list — "
                                 "keep the whole list on one comment "
                                 "line"),
                        symbol="<device-state>")
        graph = _Graph(project)
        seeds = [(src, fn) for (rel, q), (src, fn) in graph.nodes.items()
                 if src.def_marker(fn, "capture-path")]
        seen: set[tuple[str, str]] = set()
        queue = [(src, fn, src.qualname(fn)) for src, fn in seeds]
        while queue:
            src, fn, seed = queue.pop()
            key = (src.rel, src.qualname(fn))
            if key in seen:
                continue
            seen.add(key)
            if src.def_marker(fn, "sync-ok"):
                continue  # documented deliberate sync boundary
            yield from self._check_fn(src, fn, seed)
            for dsrc, dfn in graph.callees(src, fn):
                queue.append((dsrc, dfn, seed))

    def _check_fn(self, src: SourceFile, fn, seed: str):
        device = _device_names(src, fn)
        bounded = _bounded_nodes(fn)
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and id(node) not in bounded:
                reason = _sync_reason(node, device)
                if reason is not None:
                    yield Finding(
                        checker=self.id, file=src.rel, line=node.lineno,
                        col=node.col_offset,
                        message=(f"{reason} — on the capture path "
                                 f"(reachable from seed {seed})"),
                        symbol=src.qualname(fn))
