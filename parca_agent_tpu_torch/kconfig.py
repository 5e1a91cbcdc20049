"""Environment probing: kernel config + container detection.

The port's copy of parca_agent_tpu's kconfig.py, over this package's
utils/vfs.py.

Role of the reference's pkg/kconfig/kconfig.go: CheckBPFEnabled parses
/proc/config.gz (or /boot/config-$(uname -r)) for the CONFIG_BPF* options
capture needs (:46-205); IsInContainer uses cpuset/sched heuristics
(:207+). Capture here needs perf_event_open rather than BPF, so the
required-option set adds CONFIG_PERF_EVENTS and the BPF ones stay
advisory (reported, not fatal) for the eventual eBPF source.
"""

from __future__ import annotations

import gzip
import io

from parca_agent_tpu_torch.utils.vfs import VFS, RealFS

REQUIRED_OPTIONS = ("CONFIG_PERF_EVENTS",)
ADVISORY_OPTIONS = (
    "CONFIG_BPF", "CONFIG_BPF_SYSCALL", "CONFIG_HAVE_EBPF_JIT",
    "CONFIG_BPF_JIT", "CONFIG_BPF_EVENTS",
)


def parse_kernel_config(text: str) -> dict[str, str]:
    out = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if "=" in line:
            k, v = line.split("=", 1)
            out[k] = v
    return out


def read_kernel_config(fs: VFS | None = None) -> dict[str, str]:
    fs = fs or RealFS()
    try:
        raw = fs.read_bytes("/proc/config.gz")
        text = gzip.GzipFile(fileobj=io.BytesIO(raw)).read().decode()
        return parse_kernel_config(text)
    except OSError:
        pass
    try:
        rel = fs.read_bytes("/proc/sys/kernel/osrelease").decode().strip()
        return parse_kernel_config(
            fs.read_bytes(f"/boot/config-{rel}").decode()
        )
    except OSError:
        return {}


def check_profiling_enabled(
    fs: VFS | None = None,
) -> tuple[bool, list[str], list[str]]:
    """(ok, missing_required, missing_advisory). Empty kernel config
    (common in containers without /proc/config.gz) is treated as
    ok-unknown."""
    cfg = read_kernel_config(fs)
    if not cfg:
        return True, [], []
    missing = [o for o in REQUIRED_OPTIONS if cfg.get(o) not in ("y", "m")]
    advisory = [o for o in ADVISORY_OPTIONS if cfg.get(o) not in ("y", "m")]
    return not missing, missing, advisory


def is_in_container(fs: VFS | None = None) -> bool:
    """cgroup/sched heuristics (kconfig.go:207+): pid 1's cgroup path is
    not "/" inside containers, or /.dockerenv exists."""
    fs = fs or RealFS()
    if fs.exists("/.dockerenv") or fs.exists("/run/.containerenv"):
        return True
    try:
        data = fs.read_bytes("/proc/1/cgroup").decode(errors="replace")
    except OSError:
        return False
    for line in data.splitlines():
        parts = line.split(":", 2)
        if len(parts) == 3 and parts[2] not in ("/", "/init.scope"):
            return True
    return False
