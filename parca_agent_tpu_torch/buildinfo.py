"""Build/version metadata surfaced at startup and on the status page.

The port's copy of parca_agent_tpu's buildinfo.py, on this package's
__version__.

Role of the reference's pkg/buildinfo (used at cmd/parca-agent/main.go:
194-207): it reads Go's embedded runtime/debug build info — version, VCS
revision, commit time, dirty flag. Python embeds nothing, so the analog
collects from the best available source, in order:

  1. a git checkout (running from source): `git rev-parse` / `git log`
     on the package's repository, with a dirty-tree probe;
  2. baked environment (container images set PARCA_AGENT_VCS_REVISION /
     PARCA_AGENT_VCS_TIME at build time — the Dockerfile analog of
     Go's -ldflags stamping);
  3. bare package version only.

Collection runs once (cached) and never raises: metadata must not be
able to break agent startup.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import subprocess
import sys

from parca_agent_tpu_torch import __version__


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    version: str
    vcs_revision: str = ""
    vcs_time: str = ""
    vcs_modified: bool = False
    python: str = ""

    def display(self) -> str:
        """One-line form for logs and the status page header."""
        out = self.version
        if self.vcs_revision:
            out += f" ({self.vcs_revision[:12]}"
            if self.vcs_modified:
                out += "-dirty"
            out += ")"
        return out

    def as_metrics(self) -> dict:
        """Flat labels for the /metrics info pseudo-gauge."""
        return {
            "version": self.version,
            "revision": self.vcs_revision,
            "vcs_time": self.vcs_time,
            "modified": str(self.vcs_modified).lower(),
        }


def _git(args: list[str], cwd: str) -> str:
    r = subprocess.run(["git", *args], cwd=cwd, capture_output=True,
                       text=True, timeout=5)
    return r.stdout.strip() if r.returncode == 0 else ""


@functools.lru_cache(maxsize=1)
def collect() -> BuildInfo:
    py = f"{sys.version_info.major}.{sys.version_info.minor}.{sys.version_info.micro}"
    rev = os.environ.get("PARCA_AGENT_VCS_REVISION", "")
    vtime = os.environ.get("PARCA_AGENT_VCS_TIME", "")
    modified = False
    if not rev:
        try:
            pkg_dir = os.path.dirname(os.path.abspath(__file__))
            # Only trust git when the package actually lives at the top of
            # the repository git resolves (a pip-installed package under a
            # user's unrelated checkout — dotfiles, an infra monorepo
            # holding the venv — must NOT report that repo's HEAD as this
            # agent's build).
            top = _git(["rev-parse", "--show-toplevel"], pkg_dir)
            ours = (top and os.path.realpath(top)
                    == os.path.realpath(os.path.dirname(pkg_dir)))
            rev = _git(["rev-parse", "HEAD"], pkg_dir) if ours else ""
            if rev:
                vtime = _git(["log", "-1", "--format=%cI"], pkg_dir)
                modified = bool(_git(["status", "--porcelain",
                                      "--untracked-files=no"], pkg_dir))
        except Exception:  # noqa: BLE001 - metadata must never break startup
            rev = ""
    return BuildInfo(version=__version__, vcs_revision=rev,
                     vcs_time=vtime, vcs_modified=modified, python=py)
