"""The poison-input error taxonomy for the ingest path.

Every byte the agent parses on the ingest side — ELF images, perf maps,
`/proc/<pid>/maps`, kallsyms, `.eh_frame` — is produced by an arbitrary,
untrusted host process. A malformed input must never abort a window's
profile build for every pid on the host (docs/robustness.md, "ingest
containment"): the parsers raise subclasses of :class:`PoisonInput` for
anything attributable to the INPUT (truncation, out-of-bounds offsets,
absurd table sizes), so callers can tell "this pid's inputs are poison"
apart from agent bugs and feed the per-pid error budget
(runtime/quarantine.py) instead of failing the window.

The taxonomy lives in utils (the bottom layer) because both the parsers
(elf/, process/) and the containment layer need it without importing
each other. The port's copy of parca_agent_tpu's utils/poison.py.

Each subclass carries a ``site`` matching the fault-injection site of the
parser that raised it (utils/faults.py), so chaos-injected faults and
real poison flow through the same attribution path.
"""

from __future__ import annotations

import os


class PoisonInput(ValueError):
    """Malformed untrusted input detected by an ingest-side parser.

    ``site`` names the parser (and its fault-injection site); callers
    catch PoisonInput, attribute the fault to the pid whose input was
    being parsed, and degrade that pid instead of dropping the window.
    """

    site = "ingest.parse"


class OversizedInput(PoisonInput):
    """Untrusted input larger than its ingest byte cap. Raised by
    read_bounded BEFORE the input is fully materialized — the cap bounds
    the read itself, not just the parse."""

    def __init__(self, path: str, cap: int, site: str):
        self.site = site
        super().__init__(f"{path} exceeds ingest byte cap ({cap})")


# ELF images the ingest path opens are mapped EXECUTABLE files; real
# production binaries reach several hundred MB (chromium ~0.3 GB,
# bundled single-file runtimes ~0.9 GB observed in the wild), so the cap
# sits well above them. A PROT_EXEC-mapped multi-GB-plus sparse file is
# a resource bomb: reading it whole would OOM the agent before any
# parser cap could fire; past the cap the read stops and the pid is
# charged. Note the bound IS the cap — a file at/under it still costs
# that much transient RSS (it must be parsed to be rejected), so
# memory-capped deployments should lower PARCA_ELF_READ_CAP below their
# container limit.
ELF_READ_CAP = int(os.environ.get("PARCA_ELF_READ_CAP", 2 << 30))


def read_bounded(fs, path: str, cap: int, site: str = "ingest.parse"
                 ) -> bytes:
    """Read at most ``cap`` bytes of an untrusted file; a larger file
    raises OversizedInput (a PoisonInput, chargeable to the owning pid)
    having cost at most cap+1 bytes of memory."""
    with fs.open(path) as f:
        data = f.read(cap + 1)
    if len(data) > cap:
        raise OversizedInput(path, cap, site)
    return data


def poison_sites() -> tuple[str, ...]:
    """The named ingest fault sites (mirrors utils/faults.py docs)."""
    return ("elf.read", "perfmap.parse", "maps.parse",
            "symbolize.kernel", "unwind.build")
