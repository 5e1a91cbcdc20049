"""Metadata providers: each contributes labels for a PID.

Role of the reference's pkg/metadata/{metadata,process,cgroup,system,
compiler,target,service_discovery}.go. The Provider protocol mirrors
metadata.go:24-28 — {name, labels(pid), should_cache}; stateless providers
are cached by the labels manager, stateful ones (service discovery) serve
from their own state (metadata.go:30-78).

The port's copy of parca_agent_tpu's metadata/providers.py.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Protocol

from parca_agent_tpu_torch.utils.poison import PoisonInput
from parca_agent_tpu_torch.utils.vfs import VFS, RealFS


class Provider(Protocol):
    name: str
    should_cache: bool

    def labels(self, pid: int) -> dict[str, str]: ...


class CgroupParseError(PoisonInput):
    """A `/proc/<pid>/cgroup` file past its sanity caps. The file is
    kernel-generated, but its CONTENT is attacker-influenced (cgroup
    paths are named by whoever creates the cgroup) and pid reuse means
    the read can race an exit — same PoisonInput discipline as the
    maps/perfmap parsers (docs/robustness.md "ingest containment")."""

    site = "cgroup.parse"


# A real cgroup file is a handful of lines (one per v1 hierarchy plus
# the v2 line); hundreds means something is feeding us garbage. The
# byte cap bounds the READ itself through poison.read_bounded at every
# call site (CgroupProvider below, runtime/admission.py TenantResolver).
CGROUP_MAX_BYTES = 1 << 20
_CGROUP_MAX_ROWS = 256


def parse_cgroup_path(data: bytes) -> str | None:
    """Primary cgroup path out of a `/proc/<pid>/cgroup` blob — prefer
    the v2 line ("0::/path"), else the cpu controller, else the first
    well-formed line. Malformed lines are skipped (kernel files can
    still truncate mid-write on pid exit); a file past the row cap
    raises CgroupParseError (a PoisonInput, chargeable to the pid)."""
    best = None
    rows = 0
    for line in data.decode(errors="replace").splitlines():
        rows += 1
        if rows > _CGROUP_MAX_ROWS:
            raise CgroupParseError(
                f"cgroup file exceeds row cap ({_CGROUP_MAX_ROWS})")
        parts = line.split(":", 2)
        if len(parts) != 3:
            continue
        if parts[0] == "0" and parts[1] == "":
            return parts[2]
        if best is None or "cpu" in parts[1].split(","):
            best = parts[2]
    return best


@dataclasses.dataclass
class ProcessProvider:
    """comm + executable path (reference process.go)."""

    fs: VFS = dataclasses.field(default_factory=RealFS)
    name: str = "process"
    should_cache: bool = True

    def labels(self, pid: int) -> dict[str, str]:
        out: dict[str, str] = {}
        try:
            out["comm"] = self.fs.read_bytes(
                f"/proc/{pid}/comm"
            ).decode(errors="replace").strip()
        except OSError:
            pass
        try:
            # /proc/pid/exe is a symlink; the cmdline's argv[0] is the
            # VFS-friendly stand-in (FakeFS has no symlinks).
            cmdline = self.fs.read_bytes(f"/proc/{pid}/cmdline")
            argv0 = cmdline.split(b"\x00", 1)[0].decode(errors="replace")
            if argv0:
                out["executable"] = argv0
        except OSError:
            pass
        return out


@dataclasses.dataclass
class CgroupProvider:
    """Primary cgroup path (reference cgroup.go:25-60)."""

    fs: VFS = dataclasses.field(default_factory=RealFS)
    name: str = "cgroup"
    should_cache: bool = True

    def labels(self, pid: int) -> dict[str, str]:
        from parca_agent_tpu_torch.utils.poison import read_bounded

        # Bounded like every other /proc reader (utils/poison.py): the
        # read itself is capped, the parse is row-capped, and poison
        # costs this pid its cgroup label, never the label pass.
        try:
            data = read_bounded(self.fs, f"/proc/{pid}/cgroup",
                                CGROUP_MAX_BYTES, site="cgroup.parse")
            best = parse_cgroup_path(data)
        except (OSError, PoisonInput):
            return {}
        return {"cgroup_name": best} if best else {}


@dataclasses.dataclass
class TenantProvider:
    """PID -> tenant identity label, fed by the admission layer's
    TenantResolver (runtime/admission.py). The label key is the
    admission layer's TENANT_LABEL ("tenant"), so the read path's
    `tenant=` selector shorthand (/query, /hotspots) slices by exactly
    the identity the quotas enforce."""

    resolver: object = None
    name: str = "tenant"
    should_cache: bool = True

    def labels(self, pid: int) -> dict[str, str]:
        if self.resolver is None:
            return {}
        tenant = self.resolver.resolve(pid)
        return {"tenant": tenant} if tenant else {}


@dataclasses.dataclass
class SystemProvider:
    """Kernel release (reference system.go:41-90)."""

    fs: VFS = dataclasses.field(default_factory=RealFS)
    name: str = "system"
    should_cache: bool = True

    def labels(self, pid: int) -> dict[str, str]:
        try:
            rel = self.fs.read_bytes(
                "/proc/sys/kernel/osrelease"
            ).decode().strip()
            return {"kernel_release": rel}
        except OSError:
            return {}


_GO_BUILDINFO = re.compile(rb"\xff Go buildinf:")


@dataclasses.dataclass
class CompilerProvider:
    """Compiler/runtime classification of the main executable (role of
    reference compiler.go:48-80, which uses the ainur library): Go binaries
    via the go build-id note / buildinfo magic, else C/C++; plus
    static/stripped bits from the ELF structure."""

    fs: VFS = dataclasses.field(default_factory=RealFS)
    name: str = "compiler"
    should_cache: bool = True

    def labels(self, pid: int) -> dict[str, str]:
        from parca_agent_tpu_torch.elf.buildid import go_build_id
        from parca_agent_tpu_torch.elf.reader import ElfFile
        from parca_agent_tpu_torch.utils import poison
        from parca_agent_tpu_torch.utils.poison import PoisonInput, read_bounded

        try:
            # /proc/pid/exe is a symlink to the main executable; reading
            # through it works on the real fs, and FakeFS tests key it
            # directly. Bounded: the target controls what it execs.
            data = read_bounded(self.fs, f"/proc/{pid}/exe",
                                poison.ELF_READ_CAP)
        except (OSError, PoisonInput):
            return {}
        try:
            ef = ElfFile(data)
        except PoisonInput:
            return {}
        is_go = go_build_id(ef) is not None or \
            ef.section(".go.buildinfo") is not None
        has_dynamic = any(s.name == ".dynamic" for s in ef.sections)
        stripped = ef.section(".symtab") is None
        return {
            "compiler": "go" if is_go else "cc",
            "static": str(not has_dynamic).lower(),
            "stripped": str(stripped).lower(),
        }


@dataclasses.dataclass
class TargetProvider:
    """Node name + operator-supplied external labels (reference
    target.go:24-45)."""

    node: str = ""
    external: dict[str, str] = dataclasses.field(default_factory=dict)
    name: str = "target"
    should_cache: bool = False  # cheap, and external labels can be reloaded

    def labels(self, pid: int) -> dict[str, str]:
        out = dict(self.external)
        if self.node:
            out["node"] = self.node
        return out


@dataclasses.dataclass
class ServiceDiscoveryProvider:
    """PID -> discovery group labels, fed by the discovery manager's state
    (reference service_discovery.go:28+ consuming the SyncCh)."""

    name: str = "service_discovery"
    should_cache: bool = False  # stateful; state IS the cache
    _state: dict[int, dict[str, str]] = dataclasses.field(default_factory=dict)

    def update(self, groups) -> None:
        """groups: iterable of discovery.Group."""
        state: dict[int, dict[str, str]] = {}
        for g in groups:
            for pid in g.pids:
                state.setdefault(pid, {}).update(g.labels)
        self._state = state

    def labels(self, pid: int) -> dict[str, str]:
        return dict(self._state.get(pid, {}))
