"""The port's multi-tenant admission (runtime/admission.py) held to
parca_agent_tpu's.

Every case of tests/test_admission.py runs here through the port
(tests/torch_port_cases.py), with the original's assertions, but one:
``test_cgroup_fuzz_no_taxonomy_escapes`` drives the original's fuzz
harness (utils/fuzz.py, not in the port) on the JAX parsers; the port's
case feeds the same seeded mutants of its cgroup corpus to both
packages' parsers and holds the outcomes equal.

Below them, the same seeded tenants (64 pod cgroups on a fake
filesystem, Zipf-skewed mass, a noisy tenant and a pid storm) go through
both packages' resolvers and controllers over a sequence of windows: the
ladder levels of every pid, the shed order, the metrics, the /healthz
section and the shard placement are compared exactly, and so are the
admission.resolve and admission.shed chaos sites' counters. The last
cases put one tenant's rows in one home shard of both packages' sharded
dictionaries at a capacity it cannot fit, and hold the outcome equal.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_port_cases import (  # noqa: E402
    FakeClock,
    pkg,
    plain,
    port_cases,
    port_on_cpu,  # noqa: F401 - autouse fixture
)

port_cases("test_admission", globals(),
           replaced=("test_cgroup_fuzz_no_taxonomy_escapes",))

BOTH = ("jax", "port")


def test_cgroup_fuzz_no_taxonomy_escapes():
    """300 seeded mutants of the cgroup corpus from the port's harness
    (utils/fuzz.py), the same stream the original's harness makes,
    through both packages' parse and tenant mapping: every one is benign
    or a PoisonInput, and each outcome (the tenant, or the poison's
    message) is the original's."""
    import random

    streams = {}
    for which in BOTH:
        fuzz = pkg(which, "utils.fuzz")
        corpus, _ = fuzz.PARSERS["cgroup"]
        rng = random.Random(42)
        streams[which] = [fuzz.mutate(rng, corpus()) for _ in range(300)]
    assert streams["port"] == streams["jax"]
    mutants = streams["port"]
    outcomes = {}
    for which in BOTH:
        prov = pkg(which, "metadata.providers")
        adm = pkg(which, "runtime.admission")
        poison = pkg(which, "utils.poison").PoisonInput
        got = []
        for data in mutants:
            try:
                got.append(("benign", adm.tenant_from_cgroup(
                    prov.parse_cgroup_path(data))))
            except poison as e:
                got.append(("contained", str(e)))
        outcomes[which] = got
    assert outcomes["jax"] == outcomes["port"]
    kinds = {k for k, _ in outcomes["port"]}
    assert "benign" in kinds


def _tenant_fs(which, n_pids=2000, n_pods=64, seed=5):
    """n_pids pids over n_pods pod cgroups (pid i in pod i % n_pods),
    plus a few pids with no cgroup file (the unknown tenant's path)."""
    vfs = pkg(which, "utils.vfs")
    files = {
        f"/proc/{pid}/cgroup":
        b"0::/kubepods/burstable/pod%08x-0000-1111-2222-%012d/c\n"
        % (0xAB000000 + pid % n_pods, pid % n_pods)
        for pid in range(1, n_pids + 1)}
    return vfs.FakeFS(files)


def _usage(seed=5, n_pids=2000, n_pods=64, windows=12):
    """Per window, each pid's samples: Zipf-skewed by pod, a storm of
    new pids in window 6, the heaviest pod 10x from window 4."""
    rng = np.random.default_rng(seed)
    weight = 1.0 / np.arange(1, n_pods + 1) ** 1.2
    out = []
    for w in range(windows):
        pids = np.arange(1, n_pids + 1)
        live = rng.random(n_pids) < 0.8
        if w == 6:
            live[:] = True
        pods = pids % n_pods
        counts = rng.poisson(400 * weight[pods]) + 1
        if w >= 4:
            counts[pods == 0] *= 10
        out.append((pids[live].tolist(), counts[live].tolist()))
    return out


def _controller(which, fs, clock):
    adm = pkg(which, "runtime.admission")
    return adm.AdmissionController(
        adm.TenantResolver(fs=fs, clock=clock),
        quota_samples=30_000, quota_pids=40, burst_windows=2,
        storm_new_pids=500,
        overload=adm.OverloadPolicy(close_latency_s=0.5,
                                    registry_rows=50_000, backlog=2,
                                    shed_after=2, recover_after=2),
        top_n=8, window_s=10.0)


def test_parity_levels_shed_order_metrics_and_snapshot():
    """Twelve windows of quota pressure, a pid storm and an overload
    spell: every pid's level after each tick, the metrics and the
    /healthz section, equal in both packages."""
    usage = _usage()
    got = {}
    for which in BOTH:
        clock = FakeClock()
        adm = _controller(which, _tenant_fs(which), clock)
        trace = []
        for w, (pids, counts) in enumerate(usage):
            adm.account_window(pids, counts)
            adm.tick_window(close_latency_s=2.0 if 5 <= w < 9 else 0.1,
                            registry_rows=1000 * w, backlog=w % 3)
            clock.t += 10.0
            trace.append([adm.level_for(p) for p in range(1, 2001)])
        got[which] = (trace, plain(adm.metrics()), plain(adm.snapshot()),
                      [adm.shard_of(p, n) for p in range(1, 200)
                       for n in (1, 3, 8)])
    trace = np.array(got["port"][0])
    assert trace.max() == 2 and (trace == 0).any()
    assert got["jax"] == got["port"]


def test_parity_admission_http_surfaces():
    """The admission families on /metrics and the /healthz section of
    both packages' servers over equal controllers."""
    import json
    import urllib.request

    usage = _usage(windows=6)
    got = {}
    for which in BOTH:
        clock = FakeClock()
        adm = _controller(which, _tenant_fs(which), clock)
        for pids, counts in usage:
            adm.account_window(pids, counts)
            adm.tick_window(close_latency_s=1.0)
        web = pkg(which, "web")
        text = web.render_metrics([], admission=adm)
        srv = web.AgentHTTPServer(port=0, profilers=[], admission=adm)
        srv.start()
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}/healthz", timeout=10) as r:
                health = json.loads(r.read())
        finally:
            srv.stop()
        got[which] = ([ln for ln in text.splitlines()
                       if "tenant" in ln or "admission" in ln
                       or "fork_storm" in ln], health["admission"])
    assert got["port"][0]
    assert got["jax"] == got["port"]


@pytest.mark.parametrize("spec", ["admission.resolve:error:p=0.3",
                                  "admission.shed:error:p=0.5"])
def test_parity_admission_chaos_counters(spec):
    usage = _usage(windows=8)
    got = {}
    for which in BOTH:
        faults = pkg(which, "utils.faults")
        faults.install(faults.FaultInjector.from_spec(spec, seed=9))
        try:
            clock = FakeClock()
            adm = _controller(which, _tenant_fs(which), clock)
            for w, (pids, counts) in enumerate(usage):
                adm.account_window(pids, counts)
                adm.tick_window(close_latency_s=2.0)
                clock.t += 10.0
            fired = faults.get().stats()
        finally:
            faults.install(None)
        got[which] = fired, plain(adm.metrics())
    assert got["port"][0]
    assert got["jax"] == got["port"]


def _one_tenant_pair(capacity, n_shards, overflow):
    """Both packages' sharded dictionaries with every pid routed to one
    home shard (one tenant), as the CLI installs admission's shard_of."""
    from parca_agent_tpu.aggregator.sharded import ShardedDictAggregator as J
    from parca_agent_tpu.parallel.mesh import fleet_mesh
    from parca_agent_tpu_torch.aggregator.sharded import ShardedDictAggregator

    out = []
    for which, agg in (
            ("jax", J(capacity=capacity, mesh=fleet_mesh(n_shards),
                      overflow=overflow)),
            ("port", ShardedDictAggregator(capacity=capacity,
                                           n_shards=n_shards,
                                           overflow=overflow,
                                           device="cpu"))):
        clock = FakeClock()
        adm = _controller(which, _tenant_fs(which, n_pods=1), clock)
        agg.set_shard_router(
            lambda pid, adm=adm, agg=agg: adm.shard_of(pid, agg._n_shards))
        out.append(agg)
    return out


def _one_tenant_window(which, rows):
    syn = pkg(which, "capture.synthetic")
    return syn.generate(syn.SyntheticSpec(
        n_pids=16, n_unique_stacks=rows, n_rows=rows, total_samples=rows * 4,
        mean_depth=6, seed=3))


def test_one_tenant_past_its_home_shard_degrades_to_the_sketch_in_both():
    """One tenant at 1,024 distinct stacks against 4 sub-tables of 256
    slots (the bench's 2^20 stacks against 2^18-key shards, cut to
    size): in sketch mode both packages admit what fits its home shard,
    absorb the rest into the count-min sideband and keep the mass; every
    counted row sits in that shard."""
    jd, pd_ = _one_tenant_pair(1 << 10, 4, "sketch")
    got = {}
    for which, agg in (("jax", jd), ("port", pd_)):
        snap = _one_tenant_window(which, 1024)
        counts = np.asarray(agg.window_counts(snap))
        h1, h2 = agg.id_hashes()
        homes = np.unique(np.asarray(h2)[:len(counts)][counts > 0]
                          % agg._n_shards)
        got[which] = (counts.tolist(), homes.tolist(),
                      plain(agg.sketch_info()), int(counts.sum()),
                      int(snap.counts.sum()))
    assert len(got["port"][1]) == 1
    assert got["port"][3] < got["port"][4]   # the rest went to the sketch
    assert got["jax"] == got["port"]


def test_one_tenant_past_its_home_shard_raises_the_same_in_both():
    """With overflow="raise" both packages refuse the window with the
    same message, naming the exhausted home shard."""
    jd, pd_ = _one_tenant_pair(1 << 10, 4, "raise")
    msgs = {}
    for which, agg in (("jax", jd), ("port", pd_)):
        with pytest.raises(RuntimeError) as ei:
            agg.window_counts(_one_tenant_window(which, 1024))
        msgs[which] = str(ei.value)
    assert "exhausted" in msgs["port"]
    assert msgs["jax"] == msgs["port"]
