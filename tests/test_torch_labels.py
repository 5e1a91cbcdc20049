"""The port's label pipeline (labels/, metadata/, config.py) held to
parca_agent_tpu's.

The same seeded label sets and relabel configs go through both
packages' ``relabel.process``; the providers and the labels manager read
the same FakeFS under one simulated clock; ``load_config_file`` and the
config reloader read the same YAML. Every output must be equal, ``None``
(a dropped target) included.
"""

from __future__ import annotations

import dataclasses
import random

import pytest

from parca_agent_tpu import config as jax_config
from parca_agent_tpu.labels import manager as jax_manager
from parca_agent_tpu.labels import relabel as jax_relabel
from parca_agent_tpu.metadata import providers as jax_providers
from parca_agent_tpu.utils.vfs import FakeFS as JaxFS
from parca_agent_tpu_torch import config as port_config
from parca_agent_tpu_torch.labels import manager as port_manager
from parca_agent_tpu_torch.labels import relabel as port_relabel
from parca_agent_tpu_torch.metadata import providers as port_providers
from parca_agent_tpu_torch.utils.vfs import FakeFS

ACTIONS = sorted(port_relabel.RelabelConfig._ACTIONS)
NAMES = ["comm", "pid", "node", "env", "cgroup_name", "__meta_app",
         "__meta_team", "kernel_release", "svc"]
VALUES = ["nginx", "redis", "java8", "web", "Web-1", "", "a;b", "x/y",
          "123", "$1", "é"]
REGEXES = ["(.*)", "ngin(.)", "java.*", "(w)(e)(b)", "inx", "__meta_(.+)",
           "(?P<name>[a-z]+)-(\\d)", "kernel_.*|env", "", "[0-9]+"]
REPLACEMENTS = ["$1", "${1}-x", "$2$1", "$$lit", "${name}", "$9", "const",
                "", "${1", "web-$1"]


def _labels(rng: random.Random) -> dict[str, str]:
    return {rng.choice(NAMES): rng.choice(VALUES)
            for _ in range(rng.randrange(0, 7))}


def _config(rng: random.Random, action: str) -> dict:
    d = {"action": action.upper() if rng.random() < 0.2 else action,
         "source_labels": rng.sample(NAMES, rng.randrange(0, 3)),
         "regex": rng.choice(REGEXES)}
    if rng.random() < 0.3:
        d["separator"] = rng.choice(["/", "", ";;"])
    if action in ("replace", "hashmod", "lowercase", "uppercase",
                  "keepequal", "dropequal") or rng.random() < 0.3:
        d["target_label"] = rng.choice(NAMES + ["${1}_t", "$1"])
    if action == "hashmod":
        d["modulus"] = rng.randrange(1, 9)
    if rng.random() < 0.7:
        d["replacement"] = rng.choice(REPLACEMENTS)
    return d


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("action", ACTIONS)
def test_relabel_outputs_equal(action, seed):
    rng = random.Random(ACTIONS.index(action) * 100 + seed)
    checked = 0
    for _ in range(40):
        raw = [_config(rng, action if k == 0 else rng.choice(ACTIONS))
               for k in range(rng.randrange(1, 4))]
        labels = _labels(rng)
        cfgs = []
        for d in raw:
            try:
                j = jax_relabel.RelabelConfig.from_dict(d)
            except ValueError as e:
                with pytest.raises(ValueError) as pe:
                    port_relabel.RelabelConfig.from_dict(d)
                assert str(pe.value) == str(e)
                break
            cfgs.append((j, port_relabel.RelabelConfig.from_dict(d)))
        else:
            want = jax_relabel.process(dict(labels), [j for j, _ in cfgs])
            got = port_relabel.process(dict(labels), [p for _, p in cfgs])
            assert got == want, (labels, raw)
            checked += 1
    assert checked >= 10


def test_relabel_expand_alike():
    import re

    m = re.match(r"(?P<name>a)(b)?(c)", "ac")
    for template in REPLACEMENTS + ["$", "${", "${name}$2$3$$", "$10"]:
        assert port_relabel._expand(template, m) == \
            jax_relabel._expand(template, m)


# -- the providers and the manager --------------------------------------------


def _procfs(rng: random.Random, pids) -> dict[str, bytes]:
    files = {"/proc/sys/kernel/osrelease": b"6.1.0-test\n"}
    for pid in pids:
        if rng.random() < 0.8:
            files[f"/proc/{pid}/comm"] = rng.choice(
                [b"nginx\n", b"redis-server\n", b"\xffbad\n", b"java\n"])
        if rng.random() < 0.7:
            files[f"/proc/{pid}/cmdline"] = rng.choice(
                [b"/usr/sbin/nginx\x00-g\x00", b"\x00", b"/bin/sh\x00",
                 b"python3\x00x.py\x00"])
        kind = rng.randrange(5)
        if kind == 0:
            files[f"/proc/{pid}/cgroup"] = b"0::/system.slice/a.service\n"
        elif kind == 1:
            files[f"/proc/{pid}/cgroup"] = (
                b"12:cpu,cpuacct:/kubepods/pod1/c1\n4:memory:/kubepods/x\n")
        elif kind == 2:
            files[f"/proc/{pid}/cgroup"] = b"garbage\n" * 3
        elif kind == 3:  # past the row cap: poison, no label
            files[f"/proc/{pid}/cgroup"] = b"1:cpu:/a\n" * 300
    return files


@dataclasses.dataclass
class _Group:
    """A discovery group as ServiceDiscoveryProvider.update reads it."""

    pids: tuple
    labels: dict


@pytest.mark.parametrize("seed", range(3))
def test_providers_give_equal_labels(seed):
    rng = random.Random(seed)
    pids = list(range(100, 140))
    files = _procfs(rng, pids)
    groups = [_Group((100, 101, 102), {"unit": "a.service"}),
              _Group((101, 130), {"pod": "p1", "unit": "b.service"})]
    port = [port_providers.ProcessProvider(fs=FakeFS(dict(files))),
            port_providers.CgroupProvider(fs=FakeFS(dict(files))),
            port_providers.SystemProvider(fs=FakeFS(dict(files))),
            port_providers.TargetProvider(node="n1", external={"env": "e"}),
            port_providers.ServiceDiscoveryProvider()]
    jax = [jax_providers.ProcessProvider(fs=JaxFS(dict(files))),
           jax_providers.CgroupProvider(fs=JaxFS(dict(files))),
           jax_providers.SystemProvider(fs=JaxFS(dict(files))),
           jax_providers.TargetProvider(node="n1", external={"env": "e"}),
           jax_providers.ServiceDiscoveryProvider()]
    port[-1].update(groups)
    jax[-1].update(groups)
    for p, j in zip(port, jax):
        assert (p.name, p.should_cache) == (j.name, j.should_cache)
        for pid in pids + [999]:
            assert p.labels(pid) == j.labels(pid), (p.name, pid)
    for data in (b"0::/a\n", b"1:cpu:/b\n2:mem:/c\n", b"x\n", b""):
        assert port_providers.parse_cgroup_path(data) == \
            jax_providers.parse_cgroup_path(data)


def test_compiler_and_tenant_providers_alike():
    from pathlib import Path

    fixtures = Path(__file__).parent / "fixtures"
    files = {"/proc/1/exe": (fixtures / "fixture_pie").read_bytes(),
             "/proc/2/exe": (fixtures / "fixture_nopie").read_bytes(),
             "/proc/3/exe": b"not an elf"}
    p = port_providers.CompilerProvider(fs=FakeFS(dict(files)))
    j = jax_providers.CompilerProvider(fs=JaxFS(dict(files)))
    for pid in (1, 2, 3, 4):
        assert p.labels(pid) == j.labels(pid)
    assert p.labels(1)

    class Resolver:
        def resolve(self, pid):
            return "t1" if pid % 2 else ""

    for pid in (1, 2):
        assert port_providers.TenantProvider(Resolver()).labels(pid) == \
            jax_providers.TenantProvider(Resolver()).labels(pid)
    assert port_providers.TenantProvider().labels(1) == {}


class _Clock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def _managers(files, rules, clock_p, clock_j):
    def providers(mod, fs):
        return [mod.ServiceDiscoveryProvider(), mod.ProcessProvider(fs=fs),
                mod.CgroupProvider(fs=fs), mod.SystemProvider(fs=fs),
                mod.TargetProvider(node="n1", external={"env": "e2e"})]

    port_fs, jax_fs = FakeFS(dict(files)), JaxFS(dict(files))
    port = port_manager.LabelsManager(
        providers(port_providers, port_fs),
        [port_relabel.RelabelConfig.from_dict(r) for r in rules],
        profiling_duration_s=1.0, clock=clock_p)
    jax = jax_manager.LabelsManager(
        providers(jax_providers, jax_fs),
        [jax_relabel.RelabelConfig.from_dict(r) for r in rules],
        profiling_duration_s=1.0, clock=clock_j)
    return port, jax, port_fs, jax_fs


RULES = [{"action": "labeldrop", "regex": "kernel_release"},
         {"action": "drop", "source_labels": ["comm"], "regex": "java"},
         {"action": "replace", "source_labels": ["comm", "pid"],
          "separator": "-", "regex": "(.*)-(.*)", "target_label": "svc",
          "replacement": "$1@$2"}]


@pytest.mark.parametrize("seed", range(3))
def test_labels_manager_label_sets_equal(seed):
    rng = random.Random(seed)
    pids = list(range(200, 230))
    files = _procfs(rng, pids)
    cp, cj = _Clock(), _Clock()
    port, jax, port_fs, jax_fs = _managers(files, RULES, cp, cj)
    dropped = 0
    for step in range(300):
        pid = rng.choice(pids)
        want = jax.label_set("parca_agent_cpu", pid)
        assert port.label_set("parca_agent_cpu", pid) == want
        dropped += want is None
        r = rng.random()
        if r < 0.1:  # time passes: the label cache (3 s) expires first
            cp.now += 1.7
            cj.now += 1.7
        elif r < 0.13:  # a process changes its comm behind the caches
            comm = rng.choice([b"java\n", b"nginx\n"])
            port_fs.put(f"/proc/{pid}/comm", comm)
            jax_fs.put(f"/proc/{pid}/comm", comm)
        elif r < 0.15:  # a config reload
            rules = rng.sample(RULES, rng.randrange(0, 3))
            port.apply_config([port_relabel.RelabelConfig.from_dict(d)
                               for d in rules])
            jax.apply_config([jax_relabel.RelabelConfig.from_dict(d)
                              for d in rules])
        assert port.labels(pid) == jax.labels(pid)
    assert dropped > 0


def test_labels_manager_purges_alike():
    files = _procfs(random.Random(4), range(1, 5000))
    cp, cj = _Clock(), _Clock()
    port, jax, _, _ = _managers(files, [], cp, cj)
    for pid in range(1, 4200):  # past the 4096-call purge
        if pid % 1000 == 0:
            cp.now += 100.0
            cj.now += 100.0
        assert port.label_set("x", pid) == jax.label_set("x", pid)
    assert len(port._label_cache._d) == len(jax._label_cache._d)
    assert len(port._provider_cache._d) == len(jax._provider_cache._d)


# -- the config file ----------------------------------------------------------


CONFIGS = [
    "relabel_configs:\n- action: labeldrop\n  regex: kernel_release\n",
    "relabel_configs:\n"
    "- source_labels: [comm, pid]\n  separator: '-'\n  regex: (.*)-(.*)\n"
    "  target_label: svc\n  replacement: $1@$2\n"
    "- action: hashmod\n  source_labels: [pid]\n  modulus: 4\n"
    "  target_label: shard\n"
    "- action: keep\n  source_labels: [comm]\n  regex: 12\n",
    "",
    "relabel_configs: []\n",
    "other: 1\n",
]


def _cfg_fields(cfg) -> list:
    return [(c.action, c.source_labels, c.separator, c.target_label,
             c.regex, c.modulus, c.replacement)
            for c in cfg.relabel_configs]


@pytest.mark.parametrize("text", CONFIGS)
def test_load_config_file_equal(tmp_path, text):
    pytest.importorskip("yaml")
    path = tmp_path / "cfg.yaml"
    path.write_text(text)
    assert _cfg_fields(port_config.load_config_file(str(path))) == \
        _cfg_fields(jax_config.load_config_file(str(path)))


def test_config_reloader_alike(tmp_path):
    pytest.importorskip("yaml")
    out = {}
    for name, mod in (("port", port_config), ("jax", jax_config)):
        path = tmp_path / f"{name}.yaml"
        seen = []
        r = mod.ConfigReloader(str(path), [lambda c: seen.append(
            _cfg_fields(c))], poll_s=0.01, debounce_s=0.0)
        steps = [r.check_once()]                 # no file yet
        path.write_text(CONFIGS[0])
        steps += [r.check_once(), r.check_once()]  # load, unchanged
        path.write_text("relabel_configs: [[[\n")
        steps.append(r.check_once())             # parse error: kept
        path.write_text(CONFIGS[1])
        steps.append(r.check_once())
        out[name] = (steps, seen, r.reloads, r.errors)
    assert out["port"] == out["jax"]
    assert out["jax"][0] == [False, True, False, False, True]
