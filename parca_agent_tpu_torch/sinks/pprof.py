"""The pprof sink: the existing WindowEncoder -> writer ship path,
refactored behind the Sink interface.

This is the PRIMARY backend: its output is the agent's contract with
the store, so it is deliberately nothing more than the pre-sink ship
hook behind a name — the registry invokes the exact same bound callable
(`CPUProfiler._write_encoded`) the profiler used to call directly, so
the bytes through the registry are identical by construction (and the
bench's sink_fanout phase + tests/test_sinks.py enforce the sha256).

Unlike secondary sinks, a pprof emit failure is NOT swallowed by the
registry: it propagates to the encode pipeline's ship guard, which
counts it as a ship_error exactly as before the sinks subsystem existed
— the fail-open contract protects the pprof ship FROM other sinks, not
the other way around.
"""

from __future__ import annotations


class PprofSink:
    name = "pprof"

    def __init__(self, ship=None):
        # The ship callable is bound late (CPUProfiler.__init__ calls
        # bind()): the writer path lives inside the profiler, which is
        # constructed after the CLI builds the registry.
        self._ship = ship
        self.stats = {
            "profiles": 0,
            "bytes": 0,
        }

    def bind(self, ship) -> None:
        self._ship = ship

    def emit(self, win) -> None:
        if self._ship is None:
            raise RuntimeError("pprof sink has no ship callable bound")
        # Size first: the blobs are memoryviews into the encoder's
        # template buffer and the writer's gzip pass consumes them.
        n_bytes = sum(len(b) for _, b in win.out)
        self._ship(win.out)
        self.stats["profiles"] += len(win.out)
        self.stats["bytes"] += n_bytes

    def flush(self) -> None:
        pass  # every emit is already through the writer

    def close(self) -> None:
        pass
