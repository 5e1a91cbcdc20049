"""palint: the port's AST-based invariant checker.

The port's copy of parca_agent_tpu/tools/lint, run over
``parca_agent_tpu_torch``. The same defect classes keep coming back as a
codebase grows: fields read outside their guarding lock, hooks that must
be fail-open but let an exception escape, persistent writes missing the
tmp+rename discipline, chaos sites drifting out of the registry, host
syncs creeping back onto the capture path, and hand-rolled copies of the
abandonable bounded-call guard. The always-on contract ("degrade, never
die") depends on these invariants holding, so they are machine-checked
here, where Python gives no race detector and no ``go vet``.

Six project-specific checkers (docs/static-analysis.md):

    lock-discipline   attributes annotated ``# guarded-by: _lock`` (or
                      listed in a per-class ``_GUARDED`` map) may only be
                      touched inside ``with self._lock`` in that class
    fail-open-hook    functions registered as encode-pipeline
                      snapshot/rollup hooks, supervisor probes, or
                      annotated ``# palint: fail-open`` must wrap their
                      body in a counted try/except that cannot re-raise
    crash-only-io     write-mode opens in ``# palint: persistence-root``
                      modules must flow through tmp + ``os.replace``
    chaos-site        every ``inject("<site>")`` call site must match
                      ``utils/faults.py``'s SITES registry and be
                      exercised by a ``chaos``-marked test of the port
                      (``tests/test_torch_*.py`` and the original test
                      modules they run through ``port_cases``), and vice
                      versa (no dead registry entries)
    host-sync         functions reachable from a ``# palint:
                      capture-path`` seed may not call blocking device
                      fetches: torch's ``.item()``, ``.cpu()``,
                      ``torch.cuda.synchronize()`` / ``.synchronize()``,
                      ``.tolist()``/``.numpy()``/``np.asarray``/
                      ``float``/``int`` over device state (and the
                      original's ``jax.device_get``,
                      ``.block_until_ready()``), except inside a ``with
                      device_wait():`` block (utils/bounded.py: the
                      watchdog bounds it) or a ``# palint: sync-ok``
                      def
    bounded-call      spawn-a-thread-then-``join(timeout)`` reimplements
                      utils/bounded.py:bounded_call — use it instead

Run via ``python -m parca_agent_tpu_torch.tools.lint`` (``--json`` for
machine-readable output). Inline suppressions use
``# palint: disable=<id>`` with a justification; pre-existing findings
would live in ``tools/lint/baseline.json`` so the gate fires on growth,
not history (stale baseline entries are reported, never silently kept).
The port's baseline is empty.
"""

from parca_agent_tpu_torch.tools.lint.core import (  # noqa: F401
    Finding,
    Project,
    SourceFile,
    run_checkers,
)
