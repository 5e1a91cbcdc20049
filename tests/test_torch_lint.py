"""The port's palint (tools/lint/) held to parca_agent_tpu's, and the port
held to palint.

Every case of tests/test_lint.py runs here through the port
(tests/torch_port_cases.py), with the original's assertions, but for
``test_repo_is_clean``: the port's palint runs over
``parca_agent_tpu_torch`` and must find nothing with an EMPTY baseline,
which its replacement asserts under the same name. Below them, both
packages' checkers see the original's golden fixtures and report the
same findings; the port's host-sync checker flags torch's host syncs
(``.item()``, ``.cpu()``, ``.tolist()``/``.numpy()`` over device state,
``torch.cuda.synchronize()``) on a capture path, but not inside a
``with device_wait():`` block or a ``sync-ok`` def; and the chaos-site
checker counts coverage only from the port's test modules.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_port_cases import (  # noqa: E402
    pkg,
    port_cases,
    port_on_cpu,  # noqa: F401 - autouse fixture
)

from parca_agent_tpu_torch.tools.lint.chaos_sites import (  # noqa: E402
    ChaosSiteChecker,
)
from parca_agent_tpu_torch.tools.lint.core import (  # noqa: E402
    Project,
    SourceFile,
    run_checkers,
)
from parca_agent_tpu_torch.tools.lint.host_sync import (  # noqa: E402
    HostSyncChecker,
)

original = port_cases("test_lint", globals(),
                      replaced=("test_repo_is_clean",))

BOTH = ("jax", "port")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_repo_is_clean():
    """The port's palint over parca_agent_tpu_torch: exit 0, no
    finding, no stale entry, with the committed baseline empty."""
    r = subprocess.run(
        [sys.executable, "-m", "parca_agent_tpu_torch.tools.lint", "--json"],
        capture_output=True, text=True, cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    out = json.loads(r.stdout)
    assert out["findings"] == []
    assert out["stale_baseline"] == []
    assert out["baselined"] == 0
    assert out["files"] > 100
    assert out["checkers"] == ["lock-discipline", "fail-open-hook",
                               "crash-only-io", "chaos-site", "host-sync",
                               "bounded-call"]
    with open(os.path.join(REPO, "parca_agent_tpu_torch", "tools", "lint",
                           "baseline.json")) as fp:
        assert json.load(fp)["findings"] == []


# -- both packages on the original's golden fixtures --------------------------

GOLDEN = {
    "lock-discipline": ("lock_discipline", "LockDisciplineChecker",
                        ("LOCK_BAD", "LOCK_GOOD")),
    "fail-open-hook": ("fail_open", "FailOpenChecker",
                       ("FAILOPEN_BAD", "FAILOPEN_GOOD")),
    "crash-only-io": ("crash_only_io", "CrashOnlyIOChecker",
                      ("IO_BAD", "IO_GOOD")),
    "host-sync": ("host_sync", "HostSyncChecker", ("SYNC_BAD", "SYNC_GOOD")),
    "bounded-call": ("bounded_call_check", "BoundedCallChecker",
                     ("BOUNDED_BAD", "BOUNDED_GOOD")),
}


def _findings(which, module, cls, files: dict, tests: dict | None = None):
    core = pkg(which, "tools.lint.core")
    checker = getattr(pkg(which, f"tools.lint.{module}"), cls)()
    srcs = [core.SourceFile(rel, rel, textwrap.dedent(text))
            for rel, text in files.items()]
    tsrcs = [core.SourceFile(rel, rel, text)
             for rel, text in (tests or {}).items()]
    got, suppressed = core.run_checkers(core.Project(srcs, tsrcs), [checker])
    return [f.to_dict() for f in got], suppressed


@pytest.mark.parametrize("cid", sorted(GOLDEN))
def test_parity_golden_findings(cid):
    module, cls, snippets = GOLDEN[cid]
    for snippet in snippets:
        text = getattr(original, snippet)
        out = {which: _findings(which, module, cls, {"m.py": text})
               for which in BOTH}
        assert out["jax"] == out["port"], snippet
        assert bool(out["port"][0]) == snippet.endswith("_BAD")


@pytest.mark.parametrize("sites,calls,specs", [
    (["a.b"], ["a.b", "c.d"], ["a.b:error"]),
    (["a.b", "dead.site"], ["a.b"], ["a.b:error", "dead.site:error"]),
    (["a.b", "c.d"], ["a.b", "c.d"], ["a.b:unavailable:after=5,for=60"]),
    (["actor.*"], ["actor.flush"], ["actor.profiler:crash"]),
    (["device.probe"], ["device.probe2"], ["device.probe:hang:ms=1"]),
])
def test_parity_chaos_site_findings(sites, calls, specs):
    faults_src = "SITES = {\n" + "".join(
        f'    "{s}": "doc",\n' for s in sites) + "}\n"
    work = "from x.utils import faults\n\ndef work():\n" + "".join(
        f'    faults.inject("{c}")\n' for c in calls)
    tests = ("import pytest\npytestmark = pytest.mark.chaos\n\n"
             "def test_drill():\n" + "".join(
                 f'    spec = "{s}"\n' for s in specs) + "    pass\n")
    out = {which: _findings(which, "chaos_sites", "ChaosSiteChecker",
                            {"x/utils/faults.py": faults_src,
                             "x/work.py": work},
                            {"tests/test_d.py": tests})
           for which in BOTH}
    assert out["jax"] == out["port"]


# -- torch's host syncs -------------------------------------------------------

TORCH_SYNC = """
# palint: device-state: _acc
import numpy as np
import torch

from x.utils.bounded import device_wait


class Agg:
    # palint: capture-path
    def feed(self, rows):
        self._dispatch(rows)
        self._settle()

    def _dispatch(self, rows):
        self._acc += torch.as_tensor(rows).to(self._acc.device)  # upload
        {line}

    # palint: sync-ok -- deferred settle, the kernel has completed
    def _settle(self):
        return self._acc.sum().item()
"""

BAD_SYNCS = {
    "item": "n = self._acc.sum().item()",
    "cpu": "host = self._acc.cpu()",
    "tolist": "ids = self._acc.tolist()",
    "numpy": "arr = self._acc.numpy()",
    "local": "t = torch.nonzero(self._acc)\n        n = t.tolist()",
    "synchronize": "torch.cuda.synchronize()",
    "stream": "torch.cuda.current_stream().synchronize()",
    "asarray": "a = np.asarray(self._acc)",
    "int": "n = int(self._acc[0])",
}


@pytest.mark.parametrize("kind", sorted(BAD_SYNCS))
def test_host_sync_flags_torch_syncs_on_the_capture_path(kind):
    src = TORCH_SYNC.replace("{line}", BAD_SYNCS[kind])
    got, _ = run_checkers(Project([SourceFile("m.py", "m.py",
                                              textwrap.dedent(src))]),
                          [HostSyncChecker()])
    assert len(got) == 1, [f.render() for f in got]
    f = got[0]
    assert f.checker == "host-sync" and f.symbol == "Agg._dispatch"
    assert "reachable from seed Agg.feed" in f.message
    # The same line, unseeded, is free.
    unseeded = src.replace("    # palint: capture-path\n", "")
    got, _ = run_checkers(Project([SourceFile("m.py", "m.py",
                                              textwrap.dedent(unseeded))]),
                          [HostSyncChecker()])
    assert got == []


@pytest.mark.parametrize("kind", sorted(BAD_SYNCS))
def test_host_sync_spares_syncs_inside_device_wait(kind):
    """Inside ``with device_wait():`` the device watchdog bounds the
    wait: not a finding, and nor are the helpers called from there."""
    line = BAD_SYNCS[kind].replace("\n        ", "\n            ")
    src = TORCH_SYNC.replace(
        "{line}", "with device_wait():\n            " + line
        + "\n            self._helper()") + textwrap.indent(textwrap.dedent(
            """
            def _helper(self):
                return self._acc.cpu()
            """), "    ")
    got, _ = run_checkers(Project([SourceFile("m.py", "m.py",
                                              textwrap.dedent(src))]),
                          [HostSyncChecker()])
    assert got == [], [f.render() for f in got]


def test_host_sync_leaves_host_arrays_alone():
    """``.tolist()``/``.numpy()``/``int()`` over host values (numpy, a
    torch tensor never named device state) are not device fetches."""
    src = TORCH_SYNC.replace(
        "{line}", "pids = np.asarray(rows).tolist()\n"
        "        n = int(np.asarray(rows).sum())")
    got, _ = run_checkers(Project([SourceFile("m.py", "m.py",
                                              textwrap.dedent(src))]),
                          [HostSyncChecker()])
    assert got == []


def test_host_sync_walks_the_ports_feed_path():
    """The port's own seeds: a sync added to the dictionary's dispatch
    helper is a finding; the committed tree has none."""
    path = os.path.join(REPO, "parca_agent_tpu_torch", "aggregator",
                        "dict.py")
    with open(path, encoding="utf-8") as fp:
        text = fp.read()
    rel = "parca_agent_tpu_torch/aggregator/dict.py"
    clean, _ = run_checkers(Project([SourceFile(path, rel, text)]),
                            [HostSyncChecker()])
    assert clean == []
    anchor = "        t0 = time.perf_counter()\n        out = feed_step("
    assert text.count(anchor) == 1
    bad = text.replace(anchor, "        self._acc.cpu()\n" + anchor)
    got, _ = run_checkers(Project([SourceFile(path, rel, bad)]),
                          [HostSyncChecker()])
    assert [f.symbol for f in got] == ["DictAggregator._feed_dispatch_async"]
    assert ".cpu()" in got[0].message


# -- chaos coverage from the port's test modules ------------------------------


def _tree(tmp_path, tests: dict):
    pkg_dir = tmp_path / "pkg" / "utils"
    pkg_dir.mkdir(parents=True)
    (pkg_dir / "faults.py").write_text('SITES = {"a.b": "doc"}\n')
    (tmp_path / "pkg" / "w.py").write_text(
        "from pkg.utils import faults\n\ndef f():\n"
        "    faults.inject('a.b')\n")
    (tmp_path / "tests").mkdir()
    for name, text in tests.items():
        (tmp_path / "tests" / name).write_text(text)
    proj = Project.load(str(tmp_path), package="pkg", tests="tests")
    got, _ = run_checkers(proj, [ChaosSiteChecker()])
    return sorted(os.path.basename(t.rel) for t in proj.test_files), got


CHAOS_MODULE = ("import pytest\npytestmark = pytest.mark.chaos\n\n"
                "def test_drill():\n    spec = 'a.b:error'\n")


def test_chaos_coverage_counts_only_the_ports_test_modules(tmp_path):
    # The original suite's chaos module alone is not the port's coverage.
    files, got = _tree(tmp_path, {"test_x.py": CHAOS_MODULE})
    assert files == []
    assert [f.symbol for f in got] == ["a.b"]
    assert "chaos-marked test" in got[0].message


def test_chaos_coverage_follows_port_cases(tmp_path):
    # A port test module that runs it through port_cases makes it count.
    files, got = _tree(tmp_path, {
        "test_x.py": CHAOS_MODULE,
        "test_y.py": CHAOS_MODULE,
        "test_torch_x.py": "from torch_port_cases import port_cases\n\n"
                           "port_cases('test_x', globals())\n"})
    assert files == ["test_torch_x.py", "test_x.py"]
    assert got == []


def test_chaos_coverage_from_a_port_chaos_module(tmp_path):
    files, got = _tree(tmp_path, {"test_torch_d.py": CHAOS_MODULE})
    assert files == ["test_torch_d.py"] and got == []
