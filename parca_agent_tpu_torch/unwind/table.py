"""Per-process compact unwind tables from `.eh_frame`.

Role of the reference's pkg/stack/unwind/unwind_table.go + the row
serialization in pkg/profiler/cpu/maps.go:279-421: for each executable
file-backed mapping, parse the DSO's .eh_frame, execute every FDE's CFI
program (dwarf/frame.py), relocate by the mapping base when the object is
ASLR-eligible (ET_DYN, unwind_table.go:143-158), and emit fixed-width
16-byte rows sorted by PC, range-partitioned into <=3 shards of 250k rows
(maps.go:40-43).

Row layout (numpy structured dtype, 16 B):
  pc         uint64   first runtime address the rule covers
  cfa_type   uint8    RSP / RBP / EXPRESSION / END_OF_FDE
  rbp_type   uint8    UNDEFINED / OFFSET / REGISTER / EXPRESSION
  cfa_off    int16    CFA = reg + cfa_off (or expression id for EXPRESSION)
  rbp_off    int16    saved RBP at CFA + rbp_off (OFFSET type)
  _pad       uint16

The return address is assumed at CFA-8 (x86_64 ABI); FDE rows whose RA rule
deviates are marked END_OF_FDE (unsupported) exactly like rows the
reference's unwinder refuses (cpu.bpf.c unsupported-expression stats).

The vectorized `lookup_rows` is the host twin of the BPF program's
`find_offset_for_pc` binary search (reference bpf/cpu/cpu.bpf.c:302-341);
device-side lookups reuse the mapping-join binary search in aggregator/tpu.

The port's copy of parca_agent_tpu's unwind/table.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from parca_agent_tpu_torch.dwarf.frame import (
    REG_RA,
    REG_RBP,
    REG_RSP,
    FrameError,
    RuleType,
    execute_fde,
    parse_eh_frame,
)
from parca_agent_tpu_torch.elf.executable import is_aslr_eligible
from parca_agent_tpu_torch.elf.reader import ElfError, ElfFile
from parca_agent_tpu_torch.process.maps import ProcMapping, host_path
from parca_agent_tpu_torch.utils import faults, poison
from parca_agent_tpu_torch.utils.poison import PoisonInput, read_bounded
from parca_agent_tpu_torch.utils.vfs import VFS, RealFS

ROW_DTYPE = np.dtype([
    ("pc", np.uint64),
    ("cfa_type", np.uint8),
    ("rbp_type", np.uint8),
    ("cfa_off", np.int16),
    ("rbp_off", np.int16),
    ("_pad", np.uint16),
])
assert ROW_DTYPE.itemsize == 16

# cfa_type values (role of the reference's BpfCfaType, maps.go:46-53)
CFA_TYPE_RSP = 1
CFA_TYPE_RBP = 2
CFA_TYPE_EXPRESSION = 3
CFA_TYPE_END_OF_FDE = 4

# rbp_type values (role of BpfRbpType, maps.go:55-62)
RBP_TYPE_UNDEFINED = 0
RBP_TYPE_OFFSET = 1
RBP_TYPE_REGISTER = 2
RBP_TYPE_EXPRESSION = 3

# Recognized PLT CFA expressions (reference pkg/stack/unwind/
# dwarf_expression.go:31-57): sp + 8 + (((ip & 15) >= {11,10}) << 3).
_PLT1 = bytes([0x77, 0x08, 0x80, 0x00, 0x3F, 0x1A, 0x3B, 0x2A, 0x33, 0x24, 0x22])
_PLT2 = bytes([0x77, 0x08, 0x80, 0x00, 0x3F, 0x1A, 0x3A, 0x2A, 0x33, 0x24, 0x22])
CFA_EXPR_UNKNOWN = 0
CFA_EXPR_PLT1 = 1
CFA_EXPR_PLT2 = 2

MAX_ROWS_PER_SHARD = 250_000   # maps.go:41, synced with the capture program
MAX_SHARDS = 3                 # maps.go:42-43


def identify_expression(expr: bytes) -> int:
    if expr == _PLT1:
        return CFA_EXPR_PLT1
    if expr == _PLT2:
        return CFA_EXPR_PLT2
    return CFA_EXPR_UNKNOWN


def build_compact_table(eh_frame: bytes, section_addr: int = 0,
                        bias: int = 0) -> np.ndarray:
    """One DSO's .eh_frame -> sorted compact rows (runtime PCs = link + bias)."""
    fdes = parse_eh_frame(eh_frame, section_addr)
    rows: list[tuple[int, int, int, int, int]] = []
    for fde in fdes:
        try:
            frows = execute_fde(fde)
        except (FrameError, IndexError):
            continue
        for r in frows:
            pc = (r.loc + bias) % 2**64
            cfa = r.cfa
            rbp = r.rule(REG_RBP)
            ra = r.rule(REG_RA)

            if cfa.type == RuleType.CFA and cfa.reg in (REG_RSP, REG_RBP) \
                    and -32768 <= cfa.offset <= 32767:
                cfa_type = CFA_TYPE_RSP if cfa.reg == REG_RSP else CFA_TYPE_RBP
                cfa_off = cfa.offset
            elif cfa.type == RuleType.CFA_EXPRESSION:
                eid = identify_expression(cfa.expr)
                if eid == CFA_EXPR_UNKNOWN:
                    rows.append((pc, CFA_TYPE_END_OF_FDE, 0, 0, 0))
                    continue
                cfa_type = CFA_TYPE_EXPRESSION
                cfa_off = eid
            else:
                rows.append((pc, CFA_TYPE_END_OF_FDE, 0, 0, 0))
                continue

            # x86_64: RA must sit at CFA-8. The initial CIE rule is exactly
            # that; anything else the capture-side walker can't follow.
            if not (ra.type == RuleType.OFFSET and ra.offset == -8):
                rows.append((pc, CFA_TYPE_END_OF_FDE, 0, 0, 0))
                continue

            if rbp.type == RuleType.OFFSET and -32768 <= rbp.offset <= 32767:
                rbp_type, rbp_off = RBP_TYPE_OFFSET, rbp.offset
            elif rbp.type == RuleType.REGISTER:
                rbp_type, rbp_off = RBP_TYPE_REGISTER, rbp.reg
            elif rbp.type in (RuleType.EXPRESSION, RuleType.VAL_EXPRESSION):
                rbp_type, rbp_off = RBP_TYPE_EXPRESSION, 0
            else:
                rbp_type, rbp_off = RBP_TYPE_UNDEFINED, 0

            rows.append((pc, cfa_type, rbp_type, cfa_off, rbp_off))
        # End-of-function marker so lookups past the last row of one
        # function don't leak into the gap before the next FDE.
        rows.append(((fde.pc_end + bias) % 2**64, CFA_TYPE_END_OF_FDE, 0, 0, 0))

    table = np.zeros(len(rows), ROW_DTYPE)
    for i, (pc, ct, rt, co, ro) in enumerate(rows):
        table[i] = (pc, ct, rt, co, ro, 0)
    return sort_rows(table)


def sort_rows(table: np.ndarray) -> np.ndarray:
    """Sort by pc with END_OF_FDE markers FIRST among equal pcs: when one
    function ends exactly where the next begins, the next FDE's real rule
    must govern that pc, so the marker must lose the tie in lookup_rows'
    last-row-wins search."""
    is_end = table["cfa_type"] == CFA_TYPE_END_OF_FDE
    order = np.lexsort((~is_end, table["pc"]))
    return table[order]


@dataclasses.dataclass
class UnwindTableBuilder:
    """unwind_table_for_pid: procfs + ELF -> one merged compact table.

    (reference UnwindTableForPid, unwind_table.go:117-183)

    With a quarantine registry attached, poison inputs (corrupt ELF /
    .eh_frame — PoisonInput from the parsers, chaos site `unwind.build`)
    feed the owning pid's error budget, and pids already on the
    degradation ladder skip the build entirely: their profiles ship
    addresses-only (or scalar), and the suspect binaries are not re-read
    until probation.
    """

    fs: VFS = dataclasses.field(default_factory=RealFS)
    quarantine: object = None

    def table_for_mapping(self, pid: int, m: ProcMapping) -> np.ndarray | None:
        try:
            faults.inject("unwind.build")
            data = read_bounded(self.fs, host_path(pid, m.path),
                                poison.ELF_READ_CAP, site="unwind.build")
            ef = ElfFile(data)
        except PoisonInput as e:
            self._poisoned(pid, e)
            return None
        except OSError:
            return None
        sec = ef.section(".eh_frame")
        if sec is None:
            return None
        # ASLR: ET_DYN objects are relocated by the mapping; fixed ET_EXEC
        # binaries keep link addresses (unwind_table.go:143-158). The bias
        # is the same quantity compute_base derives for ET_DYN.
        bias = 0
        if is_aslr_eligible(ef):
            seg = ef.exec_load_segment()
            if seg is None:
                return None
            from parca_agent_tpu_torch.elf.base import compute_base

            bias = compute_base(ef, seg, m.start, m.end, m.offset)
        try:
            return build_compact_table(ef.section_data(sec), sec.addr, bias)
        except PoisonInput as e:  # FrameError / ElfError from section data
            self._poisoned(pid, e)
            return None

    def _poisoned(self, pid: int, e: PoisonInput) -> None:
        if self.quarantine is not None:
            self.quarantine.record_error(pid, getattr(e, "site",
                                                      "unwind.build"), e)

    def table_for_pid(self, pid: int,
                      mappings: list[ProcMapping]) -> np.ndarray:
        if self.quarantine is not None and self.quarantine.level(pid) > 0:
            return np.zeros(0, ROW_DTYPE)  # ladder: no unwind for this pid
        t0 = self.quarantine.clock() if self.quarantine is not None else 0.0
        parts = []
        for m in mappings:
            if not (m.executable and m.file_backed):
                continue
            t = self.table_for_mapping(pid, m)
            if t is not None and len(t):
                parts.append(t)
        if self.quarantine is not None:
            # Per-pid deadline over the whole build: a CFI section that
            # executes slowly (huge FDE programs) is poison by time.
            self.quarantine.check_deadline(pid, t0)
        if not parts:
            return np.zeros(0, ROW_DTYPE)
        return sort_rows(np.concatenate(parts))


def shard_table(table: np.ndarray,
                max_shards: int | None = None) -> list[np.ndarray]:
    """Range-partition into shards of MAX_ROWS_PER_SHARD rows
    (maps.go:286-395).

    The reference truncates at 3 shards (750k rows/process) because each
    shard is one BPF map value with a kernel-verifier-bounded binary
    search (cpu.bpf.c:35-39); host/device memory has no such bound, so BY
    DEFAULT every shard is kept and giant processes keep full unwind
    coverage. Pass max_shards=MAX_SHARDS to reproduce the reference's
    hard cap (the truncation tests pin that behavior)."""
    shards = [table[i: i + MAX_ROWS_PER_SHARD]
              for i in range(0, len(table), MAX_ROWS_PER_SHARD)]
    return shards if max_shards is None else shards[:max_shards]


class ShardedTable:
    """Two-level pc lookup over range-partitioned shards — the host twin
    of the reference's (pid, shard) map layout, where find_unwind_table
    picks the shard by pc range and find_offset_for_pc binary-searches
    within it (cpu.bpf.c:380-411 then :302-341).

    Shards are uniform MAX_ROWS_PER_SHARD-row slices (last one ragged),
    so a global row index maps to (idx // SHARD, idx % SHARD) and callers
    can gather rows by the indices `lookup` returns.
    """

    def __init__(self, shards: list[np.ndarray]):
        if not shards:
            shards = [np.zeros(0, ROW_DTYPE)]
        for s in shards[:-1]:
            if len(s) != MAX_ROWS_PER_SHARD:
                raise ValueError("interior shards must be full "
                                 f"({MAX_ROWS_PER_SHARD} rows)")
        self.shards = shards
        # First pc per shard; pcs below starts[0] precede the table.
        self.starts = np.array(
            [s["pc"][0] if len(s) else np.uint64(0) for s in shards],
            np.uint64)
        self.n_rows = int(sum(len(s) for s in shards))

    @classmethod
    def from_table(cls, table: np.ndarray) -> "ShardedTable":
        return cls(shard_table(table))

    def __len__(self) -> int:
        return self.n_rows

    def lookup(self, pcs) -> np.ndarray:
        """Global governing-row index per pc, or -1 (same contract as
        lookup_rows on the merged table)."""
        pcs = np.asarray(pcs, np.uint64)
        si = np.searchsorted(self.starts, pcs, side="right").astype(
            np.int64) - 1
        out = np.full(len(pcs), -1, np.int64)
        for i, shard in enumerate(self.shards):
            sel = si == i
            if not sel.any():
                continue
            local = lookup_rows(shard, pcs[sel])
            out[sel] = np.where(
                local < 0, -1, local + i * MAX_ROWS_PER_SHARD)
        return out

    def rows(self, idx) -> np.ndarray:
        """Gather rows by global index (callers pass non-negative idx)."""
        idx = np.asarray(idx, np.int64)
        out = np.zeros(len(idx), ROW_DTYPE)
        si = idx // MAX_ROWS_PER_SHARD
        local = idx % MAX_ROWS_PER_SHARD
        for i, shard in enumerate(self.shards):
            sel = si == i
            if sel.any():
                out[sel] = shard[local[sel]]
        return out


def lookup_rows(table: np.ndarray, pcs) -> np.ndarray:
    """Vectorized binary search: index of the governing row per pc, or -1
    when the pc precedes the table or lands on an END_OF_FDE row (the
    'pc_not_covered' outcome in the reference's stats, cpu.bpf.c:161-279)."""
    pcs = np.asarray(pcs, np.uint64)
    idx = np.searchsorted(table["pc"], pcs, side="right").astype(np.int64) - 1
    safe = np.maximum(idx, 0)
    bad = (idx < 0) | (table["cfa_type"][safe] == CFA_TYPE_END_OF_FDE)
    return np.where(bad, -1, idx)
