"""`.eh_frame` parser and CFI interpreter.

Role of the reference's vendored delve fork (internal/dwarf/frame/
{parser,entries,table}.go): parse CIEs/FDEs and
execute the DW_CFA program of each FDE into per-location register-rule rows.
Written from the DWARF v4/v5 spec §6.4 and the LSB eh_frame supplement —
the structures differ from the reference's (arrays of dataclass rows, one
interpreter loop, no lazy frame contexts) but the rule taxonomy matches
(RuleUndefined..RuleCFA, table.go:13-38).

Scope: the x86_64 unwind-table pipeline needs the CFA rule and the rules
for RBP (DWARF reg 6) and RA (reg 16). All standard opcodes are executed;
expression rules are kept as raw DWARF expression bytes for the expression
identifier (unwind/plt.py) to classify, exactly how the reference treats
them (pkg/stack/unwind/dwarf_expression.go:31-57).

The port's copy of parca_agent_tpu's dwarf/frame.py.
"""

from __future__ import annotations

import dataclasses
import enum
import struct

from parca_agent_tpu_torch.utils.poison import PoisonInput

# x86_64 DWARF register numbers (System V ABI).
REG_RBP = 6
REG_RSP = 7
REG_RA = 16


class FrameError(PoisonInput):
    site = "unwind.build"


# Poison caps: .eh_frame comes
# from arbitrary host binaries; bound what one section may claim before
# the parser materializes it. glibc carries ~25k FDEs; chromium ~600k.
_MAX_CFI_ENTRIES = 2_000_000
_MAX_LEB_SHIFT = 70  # > 64 value bits in a LEB128 is malformed


# -- LEB128 -----------------------------------------------------------------


def uleb128(data: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        try:
            b = data[pos]
        except IndexError:
            raise FrameError("truncated ULEB128") from None
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > _MAX_LEB_SHIFT:
            raise FrameError("overlong ULEB128")


def sleb128(data: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        try:
            b = data[pos]
        except IndexError:
            raise FrameError("truncated SLEB128") from None
        pos += 1
        result |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            if b & 0x40:
                result -= 1 << shift
            return result, pos
        if shift > _MAX_LEB_SHIFT:
            raise FrameError("overlong SLEB128")


# -- DW_EH_PE pointer encodings --------------------------------------------

DW_EH_PE_omit = 0xFF
DW_EH_PE_absptr = 0x00
DW_EH_PE_uleb128 = 0x01
DW_EH_PE_udata2 = 0x02
DW_EH_PE_udata4 = 0x03
DW_EH_PE_udata8 = 0x04
DW_EH_PE_sleb128 = 0x09
DW_EH_PE_sdata2 = 0x0A
DW_EH_PE_sdata4 = 0x0B
DW_EH_PE_sdata8 = 0x0C
DW_EH_PE_pcrel = 0x10
DW_EH_PE_textrel = 0x20
DW_EH_PE_datarel = 0x30
DW_EH_PE_funcrel = 0x40
DW_EH_PE_aligned = 0x50
DW_EH_PE_indirect = 0x80


def read_encoded(data: bytes, pos: int, enc: int, section_addr: int) -> tuple[int, int]:
    """Decode one DW_EH_PE-encoded pointer at `pos`; returns (value, new_pos).
    `section_addr` is the virtual address of .eh_frame (for pcrel)."""
    if enc == DW_EH_PE_omit:
        return 0, pos
    fmt = enc & 0x0F
    app = enc & 0x70
    start = pos
    if fmt == DW_EH_PE_absptr:
        v = struct.unpack_from("<Q", data, pos)[0]
        pos += 8
    elif fmt == DW_EH_PE_uleb128:
        v, pos = uleb128(data, pos)
    elif fmt == DW_EH_PE_udata2:
        v = struct.unpack_from("<H", data, pos)[0]
        pos += 2
    elif fmt == DW_EH_PE_udata4:
        v = struct.unpack_from("<I", data, pos)[0]
        pos += 4
    elif fmt == DW_EH_PE_udata8:
        v = struct.unpack_from("<Q", data, pos)[0]
        pos += 8
    elif fmt == DW_EH_PE_sleb128:
        v, pos = sleb128(data, pos)
    elif fmt == DW_EH_PE_sdata2:
        v = struct.unpack_from("<h", data, pos)[0]
        pos += 2
    elif fmt == DW_EH_PE_sdata4:
        v = struct.unpack_from("<i", data, pos)[0]
        pos += 4
    elif fmt == DW_EH_PE_sdata8:
        v = struct.unpack_from("<q", data, pos)[0]
        pos += 8
    else:
        raise FrameError(f"unsupported pointer encoding {enc:#x}")
    if app == DW_EH_PE_pcrel:
        v += section_addr + start
    elif app in (DW_EH_PE_textrel, DW_EH_PE_datarel, DW_EH_PE_funcrel):
        raise FrameError(f"unsupported pointer application {enc:#x}")
    return v % 2**64, pos


# -- rule model -------------------------------------------------------------


class RuleType(enum.IntEnum):
    UNDEFINED = 0
    SAME_VALUE = 1
    OFFSET = 2        # value at CFA + offset
    VAL_OFFSET = 3    # value is CFA + offset
    REGISTER = 4      # value is in another register
    EXPRESSION = 5    # value at eval(expr)
    VAL_EXPRESSION = 6  # value is eval(expr)
    CFA = 7           # CFA rule: register + offset
    CFA_EXPRESSION = 8  # CFA rule: eval(expr)


@dataclasses.dataclass(frozen=True)
class RegRule:
    type: RuleType
    reg: int = 0
    offset: int = 0
    expr: bytes = b""


UNDEFINED = RegRule(RuleType.UNDEFINED)
SAME_VALUE = RegRule(RuleType.SAME_VALUE)


@dataclasses.dataclass
class Row:
    """Register rules taking effect at `loc` (until the next row's loc)."""

    loc: int
    cfa: RegRule
    regs: dict[int, RegRule]

    def rule(self, reg: int) -> RegRule:
        return self.regs.get(reg, UNDEFINED)


@dataclasses.dataclass
class CIE:
    offset: int
    code_align: int
    data_align: int
    ra_reg: int
    initial_instructions: bytes
    fde_pointer_enc: int = DW_EH_PE_absptr
    augmentation: str = ""
    aug_data: bytes = b""


@dataclasses.dataclass
class FDE:
    offset: int
    cie: CIE
    pc_begin: int
    pc_range: int
    instructions: bytes

    @property
    def pc_end(self) -> int:
        return self.pc_begin + self.pc_range


# -- parsing ---------------------------------------------------------------


def parse_eh_frame(data: bytes, section_addr: int = 0) -> list[FDE]:
    """Parse an .eh_frame section into FDEs (with their CIEs resolved).

    `section_addr` is the sh_addr of .eh_frame, needed for pcrel pointer
    encodings (the common case for PIC code).

    Malformed input raises FrameError (a PoisonInput) — including any
    truncation an untrusted binary can produce (struct/index failures are
    converted so nothing but the taxonomy escapes).
    """
    try:
        return _parse_eh_frame(data, section_addr)
    except FrameError:
        raise
    except (IndexError, struct.error, ValueError) as e:
        raise FrameError(f"malformed .eh_frame: {e!r}") from None


def _parse_eh_frame(data: bytes, section_addr: int) -> list[FDE]:
    cies: dict[int, CIE] = {}
    fdes: list[FDE] = []
    pos = 0
    n = len(data)
    while pos + 4 <= n:
        if len(cies) + len(fdes) >= _MAX_CFI_ENTRIES:
            raise FrameError("CFI entry count exceeds cap")
        entry_off = pos
        length = struct.unpack_from("<I", data, pos)[0]
        pos += 4
        if length == 0:  # ZERO terminator
            break
        if length == 0xFFFFFFFF:
            length = struct.unpack_from("<Q", data, pos)[0]
            pos += 8
        end = pos + length
        if end > n:
            raise FrameError("CFI entry overruns section")
        cie_ptr = struct.unpack_from("<I", data, pos)[0]
        body = pos + 4
        if cie_ptr == 0:
            cies[entry_off] = _parse_cie(data, entry_off, body, end)
        else:
            # eh_frame: CIE pointer is a self-relative back-offset from the
            # CIE-pointer field itself (unlike .debug_frame's section offset).
            cie_off = pos - cie_ptr
            cie = cies.get(cie_off)
            if cie is None:
                raise FrameError(f"FDE at {entry_off:#x} references unknown CIE")
            fdes.append(_parse_fde(data, entry_off, body, end, cie, section_addr))
        pos = end
    fdes.sort(key=lambda f: f.pc_begin)
    return fdes


def _parse_cie(data: bytes, entry_off: int, pos: int, end: int) -> CIE:
    if pos >= len(data):
        raise FrameError("truncated CIE")
    version = data[pos]
    pos += 1
    if version not in (1, 3, 4):
        raise FrameError(f"unsupported CIE version {version}")
    aug_end = data.find(b"\x00", pos, end)
    if aug_end < 0:
        raise FrameError("unterminated CIE augmentation string")
    augmentation = data[pos:aug_end].decode(errors="replace")
    pos = aug_end + 1
    if version == 4:
        pos += 2  # address_size, segment_size
    code_align, pos = uleb128(data, pos)
    data_align, pos = sleb128(data, pos)
    if version == 1:
        ra_reg = data[pos]
        pos += 1
    else:
        ra_reg, pos = uleb128(data, pos)
    fde_enc = DW_EH_PE_absptr
    aug_data = b""
    if augmentation.startswith("z"):
        aug_len, pos = uleb128(data, pos)
        aug_data = data[pos: pos + aug_len]
        apos = 0
        for ch in augmentation[1:]:
            if ch == "R":
                fde_enc = aug_data[apos]
                apos += 1
            elif ch == "L":
                apos += 1  # LSDA encoding byte
            elif ch == "P":
                penc = aug_data[apos]
                apos += 1
                _, apos = read_encoded(aug_data, apos, penc & 0x0F, 0)
            elif ch == "S":
                pass  # signal frame marker
        pos += aug_len
    return CIE(entry_off, code_align, data_align, ra_reg,
               data[pos:end], fde_enc, augmentation, aug_data)


def _parse_fde(data: bytes, entry_off: int, pos: int, end: int, cie: CIE,
               section_addr: int) -> FDE:
    pc_begin, pos = read_encoded(data, pos, cie.fde_pointer_enc, section_addr)
    # pc_range is always absolute-format, same size encoding without app bits
    pc_range, pos = read_encoded(data, pos, cie.fde_pointer_enc & 0x0F, 0)
    if cie.augmentation.startswith("z"):
        aug_len, pos = uleb128(data, pos)
        pos += aug_len
    return FDE(entry_off, cie, pc_begin, pc_range, data[pos:end])


# -- interpreter ------------------------------------------------------------

_DW_CFA_advance_loc = 0x40
_DW_CFA_offset = 0x80
_DW_CFA_restore = 0xC0


def execute_fde(fde: FDE) -> list[Row]:
    """Run CIE initial instructions + FDE instructions; one Row per distinct
    starting location (reference table.go ExecuteDwarfProgram). A CFA
    program truncated or corrupted by its producer raises FrameError."""
    cie = fde.cie
    ctx = _Ctx(fde.pc_begin, cie.code_align, cie.data_align)
    try:
        ctx.run(cie.initial_instructions)
        ctx.initial = {k: v for k, v in ctx.regs.items()}
        ctx.initial_cfa = ctx.cfa
        rows = [ctx.snapshot()]

        def on_advance():
            rows.append(ctx.snapshot())

        ctx.on_advance = on_advance
        ctx.run(fde.instructions)
    except FrameError:
        raise
    except (IndexError, struct.error) as e:
        raise FrameError(f"malformed CFA program: {e!r}") from None
    # Rows are emitted on advance with the PREVIOUS state; the final state
    # needs recording too.
    rows.append(ctx.snapshot())
    # Snapshot semantics: snapshot() records state for current loc; advancing
    # emits the new loc row. Collapse duplicate locs keeping the LAST state.
    out: list[Row] = []
    for r in rows:
        if out and out[-1].loc == r.loc:
            out[-1] = r
        else:
            out.append(r)
    return out


class _Ctx:
    def __init__(self, loc: int, code_align: int, data_align: int):
        self.loc = loc
        self.code_align = code_align
        self.data_align = data_align
        self.cfa = UNDEFINED
        self.regs: dict[int, RegRule] = {}
        self.initial: dict[int, RegRule] = {}
        self.initial_cfa = UNDEFINED
        self.stack: list[tuple[RegRule, dict[int, RegRule]]] = []
        self.on_advance = lambda: None

    def snapshot(self) -> Row:
        return Row(self.loc, self.cfa, dict(self.regs))

    def advance(self, delta: int) -> None:
        self.on_advance()
        self.loc += delta * self.code_align

    def run(self, insns: bytes) -> None:  # noqa: C901 - opcode dispatch
        pos = 0
        n = len(insns)
        while pos < n:
            op = insns[pos]
            pos += 1
            high = op & 0xC0
            low = op & 0x3F
            if high == _DW_CFA_advance_loc:
                self.advance(low)
            elif high == _DW_CFA_offset:
                off, pos = uleb128(insns, pos)
                self.regs[low] = RegRule(RuleType.OFFSET,
                                         offset=off * self.data_align)
            elif high == _DW_CFA_restore:
                self._restore(low)
            elif op == 0x00:  # nop
                pass
            elif op == 0x01:  # set_loc
                # Address-encoded per CIE; assume absptr (8 bytes) — matches
                # compilers in practice; pcrel set_loc is unseen in .eh_frame.
                self.on_advance()
                self.loc = struct.unpack_from("<Q", insns, pos)[0]
                pos += 8
            elif op == 0x02:  # advance_loc1
                self.advance(insns[pos])
                pos += 1
            elif op == 0x03:  # advance_loc2
                self.advance(struct.unpack_from("<H", insns, pos)[0])
                pos += 2
            elif op == 0x04:  # advance_loc4
                self.advance(struct.unpack_from("<I", insns, pos)[0])
                pos += 4
            elif op == 0x05:  # offset_extended
                reg, pos = uleb128(insns, pos)
                off, pos = uleb128(insns, pos)
                self.regs[reg] = RegRule(RuleType.OFFSET,
                                         offset=off * self.data_align)
            elif op == 0x06:  # restore_extended
                reg, pos = uleb128(insns, pos)
                self._restore(reg)
            elif op == 0x07:  # undefined
                reg, pos = uleb128(insns, pos)
                self.regs[reg] = UNDEFINED
            elif op == 0x08:  # same_value
                reg, pos = uleb128(insns, pos)
                self.regs[reg] = SAME_VALUE
            elif op == 0x09:  # register
                reg, pos = uleb128(insns, pos)
                src, pos = uleb128(insns, pos)
                self.regs[reg] = RegRule(RuleType.REGISTER, reg=src)
            elif op == 0x0A:  # remember_state
                self.stack.append((self.cfa, dict(self.regs)))
            elif op == 0x0B:  # restore_state
                if self.stack:
                    self.cfa, self.regs = self.stack.pop()
            elif op == 0x0C:  # def_cfa
                reg, pos = uleb128(insns, pos)
                off, pos = uleb128(insns, pos)
                self.cfa = RegRule(RuleType.CFA, reg=reg, offset=off)
            elif op == 0x0D:  # def_cfa_register
                reg, pos = uleb128(insns, pos)
                self.cfa = RegRule(RuleType.CFA, reg=reg, offset=self.cfa.offset)
            elif op == 0x0E:  # def_cfa_offset
                off, pos = uleb128(insns, pos)
                self.cfa = RegRule(RuleType.CFA, reg=self.cfa.reg, offset=off)
            elif op == 0x0F:  # def_cfa_expression
                ln, pos = uleb128(insns, pos)
                self.cfa = RegRule(RuleType.CFA_EXPRESSION,
                                   expr=insns[pos: pos + ln])
                pos += ln
            elif op == 0x10:  # expression
                reg, pos = uleb128(insns, pos)
                ln, pos = uleb128(insns, pos)
                self.regs[reg] = RegRule(RuleType.EXPRESSION,
                                         expr=insns[pos: pos + ln])
                pos += ln
            elif op == 0x11:  # offset_extended_sf
                reg, pos = uleb128(insns, pos)
                off, pos = sleb128(insns, pos)
                self.regs[reg] = RegRule(RuleType.OFFSET,
                                         offset=off * self.data_align)
            elif op == 0x12:  # def_cfa_sf
                reg, pos = uleb128(insns, pos)
                off, pos = sleb128(insns, pos)
                self.cfa = RegRule(RuleType.CFA, reg=reg,
                                   offset=off * self.data_align)
            elif op == 0x13:  # def_cfa_offset_sf
                off, pos = sleb128(insns, pos)
                self.cfa = RegRule(RuleType.CFA, reg=self.cfa.reg,
                                   offset=off * self.data_align)
            elif op == 0x14:  # val_offset
                reg, pos = uleb128(insns, pos)
                off, pos = uleb128(insns, pos)
                self.regs[reg] = RegRule(RuleType.VAL_OFFSET,
                                         offset=off * self.data_align)
            elif op == 0x15:  # val_offset_sf
                reg, pos = uleb128(insns, pos)
                off, pos = sleb128(insns, pos)
                self.regs[reg] = RegRule(RuleType.VAL_OFFSET,
                                         offset=off * self.data_align)
            elif op == 0x16:  # val_expression
                reg, pos = uleb128(insns, pos)
                ln, pos = uleb128(insns, pos)
                self.regs[reg] = RegRule(RuleType.VAL_EXPRESSION,
                                         expr=insns[pos: pos + ln])
                pos += ln
            elif op == 0x2E:  # GNU_args_size — unwind-irrelevant, skip arg
                _, pos = uleb128(insns, pos)
            elif op == 0x2F:  # GNU_negative_offset_extended
                reg, pos = uleb128(insns, pos)
                off, pos = uleb128(insns, pos)
                self.regs[reg] = RegRule(RuleType.OFFSET,
                                         offset=-off * self.data_align)
            else:
                raise FrameError(f"unknown DW_CFA opcode {op:#x}")

    def _restore(self, reg: int) -> None:
        if reg in self.initial:
            self.regs[reg] = self.initial[reg]
        else:
            self.regs.pop(reg, None)
