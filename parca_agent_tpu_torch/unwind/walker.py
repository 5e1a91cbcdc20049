"""Drain-time batched DWARF stack walker.

The consumer of the compact unwind tables (unwind/table.py) — the role the
reference's in-kernel walker plays (bpf/cpu/cpu.bpf.c:464-674: binary-search
the row for pc, compute CFA from rsp/rbp/two PLT expressions, read the
return address at CFA-8 and the saved RBP at CFA+offset, repeat up to 127
frames). The reference walks live memory with bpf_probe_read_user at sample
time; here the kernel snapshots user registers and a stack slice per sample
(PERF_SAMPLE_REGS_USER/STACK_USER, capture/live.py) and the walk happens at
drain time, vectorized with numpy ACROSS ALL SAMPLES of a pid at once: each
iteration advances every still-active sample by one frame (one batched
binary search + gathered 8-byte reads), the same data-parallel shape as the
aggregators' mapping join.

Termination mirrors the reference: pc not covered by the table with
rbp != 0 (pc_not_covered), unsupported rule (unsupported_expression),
return address 0 or out of the captured slice (truncated), pc not covered
AND rbp == 0 (stack bottom, success — cpu.bpf.c:636-660), or the
127-frame cap.

The port's copy of parca_agent_tpu's unwind/walker.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from parca_agent_tpu_torch.capture.formats import MAX_STACK_DEPTH
from parca_agent_tpu_torch.dwarf.frame import REG_RBP, REG_RSP
from parca_agent_tpu_torch.unwind.table import (
    CFA_TYPE_EXPRESSION,
    CFA_TYPE_RBP,
    CFA_TYPE_RSP,
    CFA_EXPR_PLT1,
    CFA_EXPR_PLT2,
    RBP_TYPE_OFFSET,
    RBP_TYPE_REGISTER,
    RBP_TYPE_UNDEFINED,
    ShardedTable,
    lookup_rows,
)


def _lookup(table, pcs) -> "np.ndarray":
    """pc -> governing row index on either table form (merged ndarray or
    ShardedTable two-level)."""
    if isinstance(table, ShardedTable):
        return table.lookup(pcs)
    return lookup_rows(table, pcs)


def _rows(table, idx) -> "np.ndarray":
    if isinstance(table, ShardedTable):
        return table.rows(idx)
    return table[idx]


@dataclasses.dataclass
class WalkStats:
    """Per-batch outcome counters (role of the reference's percpu_stats,
    bpf/cpu/cpu.bpf.c:161-279)."""

    total: int = 0
    success: int = 0          # reached rbp==0 stack bottom
    truncated: int = 0        # ran out of captured stack / frame cap
    pc_not_covered: int = 0
    unsupported: int = 0      # expression/register rules we don't execute

    def add(self, other: "WalkStats") -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name,
                    getattr(self, f.name) + getattr(other, f.name))


def _read_u64(stacks: np.ndarray, dyn: np.ndarray, sample: np.ndarray,
              addr_off: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Gather little-endian u64s from per-sample stack slices.

    stacks: uint8 [n, D]; dyn: int64 [n] valid bytes; sample/addr_off: [m]
    row index and byte offset per read. Returns (values, ok)."""
    ok = (addr_off >= 0) & (addr_off + 8 <= dyn[sample])
    safe = np.where(ok, addr_off, 0).astype(np.int64)
    cols = safe[:, None] + np.arange(8, dtype=np.int64)[None, :]
    b = stacks[sample[:, None], cols].astype(np.uint64)
    weights = (np.uint64(1) << (np.arange(8, dtype=np.uint64) * np.uint64(8)))
    vals = (b * weights[None, :]).sum(axis=1, dtype=np.uint64)
    return np.where(ok, vals, np.uint64(0)), ok


def walk_batch(
    table: np.ndarray,
    rip: np.ndarray,
    rsp: np.ndarray,
    rbp: np.ndarray,
    stacks: np.ndarray,
    dyn: np.ndarray,
    max_frames: int = MAX_STACK_DEPTH,
) -> tuple[np.ndarray, np.ndarray, WalkStats]:
    """Unwind n samples against one pid's merged compact table.

    rip/rsp/rbp: uint64 [n] captured registers; stacks: uint8 [n, D] memory
    at [rsp, rsp+dyn); dyn: valid bytes per sample. Returns (frames uint64
    [n, max_frames] leaf-first return addresses, depth int32 [n], stats).
    """
    n = len(rip)
    frames = np.zeros((n, max_frames), np.uint64)
    depth = np.zeros(n, np.int32)
    stats = WalkStats(total=n)
    if n == 0 or len(table) == 0:
        stats.pc_not_covered = n
        return frames, depth, stats

    pc = rip.astype(np.uint64).copy()
    sp = rsp.astype(np.uint64).copy()
    bp = rbp.astype(np.uint64).copy()
    sp0 = rsp.astype(np.uint64).copy()
    dyn = np.asarray(dyn, np.int64)
    active = pc != 0

    done_success = np.zeros(n, bool)
    done_notcov = ~active  # rip==0: nothing to walk
    done_unsupported = np.zeros(n, bool)

    for f in range(max_frames):
        if not active.any():
            break
        # Lookup pc-1 for return addresses (they point AFTER the call);
        # frame 0 is the sampled rip itself and is looked up as-is.
        lookup_pc = pc if f == 0 else pc - np.uint64(1)
        idx = _lookup(table, np.where(active, lookup_pc, np.uint64(0)))
        covered = idx >= 0
        newly_uncov = active & ~covered
        # Stack bottom per the reference (cpu.bpf.c:636-660): success only
        # when the pc is NOT covered by the table AND rbp == 0. A zero rbp
        # while the pc is still covered (rbp used as a scratch register
        # under an UNDEFINED rule) keeps walking.
        bottom = newly_uncov & (bp == 0) & (depth > 0)
        done_success |= bottom
        done_notcov |= newly_uncov & ~bottom
        active &= covered

        # Record this frame for samples still walking.
        frames[active, f] = pc[active]
        depth[active] = f + 1

        safe = np.maximum(idx, 0)
        row = _rows(table, safe)
        cfa_t = row["cfa_type"]
        cfa_off = row["cfa_off"].astype(np.int64)

        is_rsp = cfa_t == CFA_TYPE_RSP
        is_rbp = cfa_t == CFA_TYPE_RBP
        is_expr = cfa_t == CFA_TYPE_EXPRESSION
        # The two recognized PLT expressions (dwarf_expression.go:31-57):
        # cfa = rsp + 8 + (((rip & 15) >= threshold) << 3).
        thr = np.where(cfa_off == CFA_EXPR_PLT1, 11,
                       np.where(cfa_off == CFA_EXPR_PLT2, 10, 99))
        plt_extra = ((pc & np.uint64(15)) >=
                     thr.astype(np.uint64)).astype(np.uint64) << np.uint64(3)
        cfa = np.where(
            is_rsp, sp + cfa_off.astype(np.uint64),
            np.where(is_rbp, bp + cfa_off.astype(np.uint64),
                     sp + np.uint64(8) + plt_extra))
        supported = is_rsp | is_rbp | (is_expr & (thr != 99))
        newly_unsup = active & ~supported
        done_unsupported |= newly_unsup
        active &= supported

        # Return address at CFA-8 (x86_64 ABI; rows with other RA rules
        # were filtered to END_OF_FDE at build time, unwind/table.py).
        aidx = np.flatnonzero(active)
        if len(aidx) == 0:
            continue
        ra_off = (cfa[aidx] - np.uint64(8) - sp0[aidx]).astype(np.int64)
        ra, ok = _read_u64(stacks, dyn, aidx, ra_off)

        # Saved RBP. OFFSET reads memory at CFA+off; UNDEFINED keeps the
        # current value (cpu.bpf.c:584-621); REGISTER takes the named
        # register's current-frame value — the walker tracks rsp and rbp,
        # so rules naming those resolve (previous rbp = this frame's
        # rsp/rbp); other registers aren't tracked and stay unsupported.
        # The reference bails on ALL register rules (cpu.bpf.c:530-533),
        # so this is a strict superset of its coverage.
        rbp_t = row["rbp_type"][aidx]
        rbp_off = row["rbp_off"][aidx].astype(np.int64)
        off_rows = rbp_t == RBP_TYPE_OFFSET
        reg_rows = rbp_t == RBP_TYPE_REGISTER
        reg_rsp = reg_rows & (rbp_off == REG_RSP)
        reg_rbp = reg_rows & (rbp_off == REG_RBP)
        new_bp = bp[aidx].copy()
        if off_rows.any():
            sel = aidx[off_rows]
            bp_off = (cfa[sel] + rbp_off[off_rows].astype(np.uint64)
                      - sp0[sel]).astype(np.int64)
            bp_vals, bp_ok = _read_u64(stacks, dyn, sel, bp_off)
            new_bp[off_rows] = np.where(bp_ok, bp_vals, np.uint64(0))
        if reg_rsp.any():
            new_bp[reg_rsp] = sp[aidx][reg_rsp]
        # reg_rbp is the identity (new_bp already holds the current rbp).
        keep = off_rows | reg_rsp | reg_rbp | (rbp_t == RBP_TYPE_UNDEFINED)

        # Advance; classify terminations. rbp == 0 does NOT terminate here:
        # the bottom-of-stack test happens at the next iteration's coverage
        # check (see above), matching the reference's ordering.
        trunc = ~ok | (ra == 0)
        unsup = ok & ~trunc & ~keep
        done_unsupported[aidx[unsup]] = True

        cont = ~trunc & keep
        active[aidx] = cont
        pc[aidx] = ra
        sp[aidx] = cfa[aidx]
        bp[aidx] = new_bp

    # Samples still active at the frame cap get one final bottom test (the
    # loop's coverage check never ran for their last return address); the
    # rest that died on a bad read are truncated-but-usable prefixes.
    if active.any():
        idx = _lookup(table, np.where(active, pc - np.uint64(1),
                                      np.uint64(0)))
        done_success |= active & (idx < 0) & (bp == 0)
    stats.success = int(done_success.sum())
    stats.pc_not_covered = int((done_notcov & (depth == 0)).sum())
    stats.unsupported = int(done_unsupported.sum())
    stats.truncated = int(
        stats.total - stats.success - stats.pc_not_covered
        - stats.unsupported)
    return frames, depth, stats
