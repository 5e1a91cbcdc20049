"""Aggregator interface and output contracts.

An Aggregator turns one WindowSnapshot into per-PID profile tables:
deduplicated stacks with summed counts, deduplicated locations with
normalized addresses and mapping joins. Everything downstream (symbolization,
labeling, pprof encoding) consumes these array-shaped tables — no per-sample
Python objects exist anywhere on the hot path, which is what lets the device
backend hand its device arrays straight through.

Output semantics mirror the reference hot loop (pkg/profiler/cpu/cpu.go:
634-718): group samples per PID, dedup identical stacks by summing counts,
dedup addresses into per-profile locations, normalize user-space addresses to
object-relative form, and attach the PID's mappings with 1-based pprof ids.
Two deliberate deviations, both semantics-preserving:

One deliberate deviation, semantics-preserving: location/sample ordering
is sorted (deterministic) rather than first-seen, since pprof consumers
treat these as sets. Normalization is `addr - base` with the ELF-derived
base carried per mapping row (pprof GetBase semantics, reference
pkg/objectfile/object_file.go:156-238); rows with no readable ELF fall
back to base = start - offset (file-offset normalization).
"""

from __future__ import annotations

import dataclasses
from typing import Protocol, Sequence

import numpy as np

from parca_agent_tpu_torch.capture.formats import WindowSnapshot


@dataclasses.dataclass(frozen=True)
class ProfileMapping:
    """One executable mapping of the profiled process (pprof Mapping)."""

    id: int            # 1-based within the profile
    start: int
    end: int
    offset: int
    path: str = ""
    build_id: str = ""
    # Normalization base (pprof GetBase semantics): object virtual address
    # = runtime address - base. Defaults to start - offset (file-offset
    # normalization) when no ELF-derived base is known; they differ by
    # p_vaddr - p_offset of the exec segment (reference
    # pkg/objectfile/object_file.go:156-238).
    base: int | None = None

    def __post_init__(self):
        if self.base is None:
            object.__setattr__(
                self, "base", (self.start - self.offset) % 2**64)


@dataclasses.dataclass
class PidProfile:
    """Aggregated profile tables for one PID over one window."""

    pid: int
    # Samples: S deduplicated stacks.
    stack_loc_ids: np.ndarray   # int32 [S, STACK_SLOTS]; 1-based loc ids, 0 pad
    stack_depths: np.ndarray    # int32 [S]
    values: np.ndarray          # int64 [S]; sample counts
    # Locations: L deduplicated addresses.
    loc_address: np.ndarray     # uint64 [L]; raw runtime address
    loc_normalized: np.ndarray  # uint64 [L]; object-relative (user) or raw (kernel)
    loc_mapping_id: np.ndarray  # int32 [L]; 1-based into mappings, 0 = unmapped
    loc_is_kernel: np.ndarray   # bool [L]
    mappings: list[ProfileMapping]
    period_ns: int
    time_ns: int
    duration_ns: int
    # Symbolization output (filled by parca_agent_tpu_torch.symbolize):
    # functions[i] = (name, system_name, filename, start_line);
    # loc_lines[l] = [(function_id_1based, line_number), ...]
    functions: list[tuple[str, str, str, int]] = dataclasses.field(default_factory=list)
    loc_lines: list[list[tuple[int, int]]] | None = None

    @property
    def n_samples(self) -> int:
        return len(self.values)

    @property
    def n_locations(self) -> int:
        return len(self.loc_address)

    def total(self) -> int:
        return int(self.values.sum())

    def check(self) -> None:
        """Internal-consistency assertions (used by tests and fixtures)."""
        s = self.stack_loc_ids.shape[0]
        assert self.stack_depths.shape == (s,) and self.values.shape == (s,)
        ls = self.n_locations
        assert self.loc_normalized.shape == (ls,)
        assert self.loc_mapping_id.shape == (ls,)
        assert self.loc_is_kernel.shape == (ls,)
        if s:
            assert int(self.stack_loc_ids.max()) <= ls
            idx = np.arange(self.stack_loc_ids.shape[1])[None, :]
            live = idx < self.stack_depths[:, None]
            assert np.all(self.stack_loc_ids[live] >= 1)
            assert np.all(self.stack_loc_ids[~live] == 0)
        if ls:
            assert int(self.loc_mapping_id.max(initial=0)) <= len(self.mappings)


WindowProfiles = Sequence[PidProfile]


class Aggregator(Protocol):
    """Aggregation backend: one snapshot in, per-PID profile tables out."""

    name: str

    def aggregate(self, snapshot: WindowSnapshot) -> list[PidProfile]:
        ...
