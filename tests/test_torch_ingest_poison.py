"""The port's ingest containment and its fuzz harness (utils/fuzz.py)
held to parca_agent_tpu's.

Every case of tests/test_ingest_poison.py runs here through the port
(tests/torch_port_cases.py), with the original's assertions: the
parsers' tolerance and caps, the injected poison at each ingest site,
the quarantine's bounds and the mutation-fuzz gate (at least 500
mutants a parser, none escaping the PoisonInput taxonomy). Below them,
the two harnesses are compared: the corpora are the same bytes (the
port's ELF corpus comes from its own elf/writer.py), the same seed gives
the same mutant stream for every parser, each mutant's outcome through
the port's parser is the original's, and fuzz_all reports the same
counts with no escape in either package.
"""

from __future__ import annotations

import random

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_port_cases import (  # noqa: E402
    pkg,
    port_cases,
    port_on_cpu,  # noqa: F401 - autouse fixture
)

port_cases("test_ingest_poison", globals())

pytestmark = pytest.mark.chaos

BOTH = ("jax", "port")
PARSER_NAMES = ("elf", "eh_frame", "perfmap", "maps", "kallsyms", "cgroup")


def test_parity_parser_registry_and_corpora():
    fz = {which: pkg(which, "utils.fuzz") for which in BOTH}
    assert tuple(fz["port"].PARSERS) == tuple(fz["jax"].PARSERS) \
        == PARSER_NAMES
    for name in PARSER_NAMES:
        assert fz["port"].PARSERS[name][0]() == fz["jax"].PARSERS[name][0]()


@pytest.mark.parametrize("seed", [0, 42, 7777])
@pytest.mark.parametrize("name", PARSER_NAMES)
def test_parity_mutant_streams(name, seed):
    """The same seed gives the same mutants, byte for byte, and each
    one's outcome through the port's driver — benign, or the poison's
    class — is the original's."""
    streams, outcomes = {}, {}
    for which in BOTH:
        fz = pkg(which, "utils.fuzz")
        poison = pkg(which, "utils.poison").PoisonInput
        corpus, driver = fz.PARSERS[name]
        rng = random.Random(seed)
        streams[which] = [fz.mutate(rng, corpus()) for _ in range(200)]
        got = []
        for data in streams[which]:
            try:
                driver(data)
                got.append("benign")
            except poison as e:
                got.append(type(e).__name__)
        outcomes[which] = got
    assert streams["jax"] == streams["port"]
    assert outcomes["jax"] == outcomes["port"]


def test_parity_fuzz_all_counts_and_no_escapes():
    reports = {which: pkg(which, "utils.fuzz").fuzz_all(n=500, seed=42)
               for which in BOTH}
    assert reports["jax"] == reports["port"]
    for name, rep in reports["port"].items():
        assert rep["mutations"] == 500
        assert rep["benign"] + rep["contained"] == 500, name
        assert rep["escapes"] == [], (name, rep["escapes"])
