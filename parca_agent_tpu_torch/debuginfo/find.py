"""Locate separate debuginfo files for a binary.

Role of the reference's pkg/debuginfo/find.go:61-229. Search order:

  1. build-id path:   <debug_dir>/.build-id/<xx>/<rest>.debug
  2. .gnu_debuglink:  the linked filename, searched in the binary's
     directory, its .debug/ subdir, and <debug_dir>/<binary dir>/ — with
     the section's CRC32 checked against the candidate (find.go:150-229)
  3. canonical:       <debug_dir><binary path>.debug

All lookups go through the target's mount namespace (/proc/PID/root...),
like every other file access in the agent.

The port's copy of parca_agent_tpu's debuginfo/find.py.
"""

from __future__ import annotations

import dataclasses
import os
import struct
import zlib

from parca_agent_tpu_torch.elf.reader import ElfFile
from parca_agent_tpu_torch.utils import poison
from parca_agent_tpu_torch.utils.poison import PoisonInput, read_bounded
from parca_agent_tpu_torch.process.maps import host_path
from parca_agent_tpu_torch.utils.vfs import VFS, RealFS

DEFAULT_DEBUG_DIRS = ("/usr/lib/debug",)


def debuglink(ef: ElfFile) -> tuple[str, int] | None:
    """(filename, crc32) from .gnu_debuglink, if present."""
    sec = ef.section(".gnu_debuglink")
    if sec is None:
        return None
    data = ef.section_data(sec)
    end = data.find(b"\x00")
    if end < 0 or len(data) < end + 4:
        return None
    name = data[:end].decode(errors="replace")
    crc_off = (end + 4) // 4 * 4
    if len(data) < crc_off + 4:
        return None
    crc = struct.unpack_from("<I", data, crc_off)[0]
    return name, crc


@dataclasses.dataclass
class Finder:
    fs: VFS = dataclasses.field(default_factory=RealFS)
    debug_dirs: tuple[str, ...] = DEFAULT_DEBUG_DIRS

    def find(self, pid: int, binary_path: str, data: bytes | None = None,
             build_id: str | None = None) -> str | None:
        """Path (host-side, through /proc/PID/root) of the best separate
        debuginfo file, or None."""
        if data is None:
            try:
                data = read_bounded(self.fs, host_path(pid, binary_path),
                                    poison.ELF_READ_CAP)
            except (OSError, PoisonInput):
                return None
        try:
            ef = ElfFile(data)
        except PoisonInput:
            return None
        if build_id is None:
            from parca_agent_tpu_torch.elf.buildid import gnu_build_id

            build_id = gnu_build_id(ef)

        # 1. by build id
        if build_id and len(build_id) > 2:
            for d in self.debug_dirs:
                p = host_path(
                    pid, f"{d}/.build-id/{build_id[:2]}/{build_id[2:]}.debug"
                )
                if self.fs.exists(p):
                    return p

        # 2. by .gnu_debuglink + CRC
        link = debuglink(ef)
        if link is not None:
            name, crc = link
            bin_dir = os.path.dirname(binary_path)
            candidates = [
                f"{bin_dir}/{name}",
                f"{bin_dir}/.debug/{name}",
            ]
            candidates += [f"{d}{bin_dir}/{name}" for d in self.debug_dirs]
            for c in candidates:
                p = host_path(pid, c)
                if not self.fs.exists(p):
                    continue
                try:
                    # Bounded: candidates live under the target's mount
                    # namespace — a staged sparse bomb must not be read.
                    if zlib.crc32(read_bounded(self.fs, p,
                                               poison.ELF_READ_CAP)) == crc:
                        return p
                except (OSError, PoisonInput):
                    continue

        # 3. canonical path
        for d in self.debug_dirs:
            p = host_path(pid, f"{d}{binary_path}.debug")
            if self.fs.exists(p):
                return p
        return None
