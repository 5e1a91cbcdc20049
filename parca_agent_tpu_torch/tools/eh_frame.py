"""Dump the computed compact unwind table for a binary.

The port's copy of parca_agent_tpu/tools/eh_frame.py (the same text for
the same binary). Role of the reference's dev tool
cmd/eh-frame/main.go:33-52 (printing via
unwind_table.go:185-233): `python -m parca_agent_tpu_torch.tools.eh_frame BIN`.
"""

from __future__ import annotations

import argparse
import sys

from parca_agent_tpu_torch.elf.reader import ElfFile
from parca_agent_tpu_torch.unwind.table import (
    CFA_TYPE_END_OF_FDE,
    CFA_TYPE_EXPRESSION,
    CFA_TYPE_RBP,
    CFA_TYPE_RSP,
    RBP_TYPE_OFFSET,
    RBP_TYPE_REGISTER,
    build_compact_table,
)

_CFA_NAMES = {CFA_TYPE_RSP: "rsp", CFA_TYPE_RBP: "rbp"}


def format_table(table) -> str:
    lines = []
    for row in table:
        pc = int(row["pc"])
        ct = int(row["cfa_type"])
        if ct == CFA_TYPE_END_OF_FDE:
            lines.append(f"\tpc: {pc:x} .... end of FDE / unsupported")
            continue
        if ct == CFA_TYPE_EXPRESSION:
            cfa = f"exp (plt {int(row['cfa_off'])})"
        else:
            cfa = f"{_CFA_NAMES[ct]}+{int(row['cfa_off'])}"
        rt = int(row["rbp_type"])
        if rt == RBP_TYPE_OFFSET:
            rbp = f"cfa{int(row['rbp_off']):+d}"
        elif rt == RBP_TYPE_REGISTER:
            rbp = f"reg {int(row['rbp_off'])}"
        else:
            rbp = "u"
        lines.append(f"\tpc: {pc:x} cfa: {cfa} rbp: {rbp} ra: cfa-8")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="print the compact DWARF unwind table for an ELF binary"
    )
    ap.add_argument("binary")
    args = ap.parse_args(argv)
    with open(args.binary, "rb") as f:
        ef = ElfFile(f.read())
    sec = ef.section(".eh_frame")
    if sec is None:
        print("no .eh_frame section", file=sys.stderr)
        return 1
    table = build_compact_table(ef.section_data(sec), sec.addr)
    print(f"{len(table)} rows")
    print(format_table(table))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
