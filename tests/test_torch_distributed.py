"""The port's multi-process fleet merge (parallel/distributed.py) on the
CPU: two agent processes form a torch.distributed group over gloo on
localhost (device="cpu") and merge with real cross-process collectives;
their results must equal parca_agent_tpu's one-process merges of the
concatenated streams, computed here. Then the bounded join, the merge
actor's degrade/rejoin state machine (with a stubbed collective, as
tests/test_device_health.py drives the JAX merger's), and the CLI's fleet
flags. Every subprocess is bounded and killed in `finally`.
"""

from __future__ import annotations

import hashlib
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from parca_agent_tpu.parallel import fleet as jax_fleet
from parca_agent_tpu.parallel.mesh import fleet_mesh as jax_mesh
from parca_agent_tpu_torch.parallel import distributed

# One intra-op thread a process (see tests/test_torch_sharded.py).
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
R = 64

_WORKER = r"""
import hashlib, json, sys
import numpy as np
import torch

torch.set_num_threads(1)
node_id, port = int(sys.argv[1]), sys.argv[2]

from parca_agent_tpu_torch.parallel.distributed import (
    FleetWindowMerger,
    fleet_initialize,
    fleet_merge_exact64_dist,
    fleet_merge_sketches_dist,
    local_fleet_mesh,
)

fleet_initialize(f"127.0.0.1:{port}", num_nodes=2, node_id=node_id,
                 timeout_s=60, device="cpu")
mesh = local_fleet_mesh()
assert mesh.n_nodes == 2 and mesh.device.type == "cpu", mesh

# Per-node streams from one pool (same seed on both nodes): a 32-row
# overlap between the nodes, hashes above 2^31 among them.
R = 64
rng = np.random.default_rng(7)
pool_h1 = rng.integers(0, 2**32, 200, dtype=np.uint64).astype(np.uint32)
pool_h2 = rng.integers(0, 2**32, 200, dtype=np.uint64).astype(np.uint32)
idx = np.arange(R) + node_id * 32
h1, h2 = pool_h1[idx], pool_h2[idx]
counts = np.full(R, node_id + 1, np.int32)

cm, regs, total = fleet_merge_sketches_dist(h1, counts)
u1, u2, uc = fleet_merge_exact64_dist(h1, h2, counts)

merger = FleetWindowMerger(interval_s=0.0, device="cpu")
# Round 1: widths differ per node (the width agreement), hashes lazy.
k = R - 8 * node_id
merger.submit_window(lambda: (h1[:k], h2[:k]), counts[:k])
merger.merge_round()
rounds = [dict(merger.fleet_stats)]
# Round 2: node 1 has no fresh window and contributes the zero stream.
if node_id == 0:
    merger.submit_window((h1[:16], h2[:16]), counts[:16])
merger.merge_round()
rounds.append(dict(merger.fleet_stats))

print(json.dumps({
    "node": node_id, "total": total,
    "cm": hashlib.sha256(cm.tobytes()).hexdigest(), "cm_dtype": str(cm.dtype),
    "regs": regs.tolist(), "u1": u1.tolist(), "u2": u2.tolist(),
    "uc": uc.tolist(), "dtypes": [str(a.dtype) for a in (u1, u2, uc)],
    "rounds": rounds}))
"""


def _env():
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"  # as torch.set_num_threads(1) above
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_pair(cmds, timeout: float):
    """Start both processes, wait for both (bounded), kill what is left."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=_env(),
                              cwd=REPO) for c in cmds]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:  # a failed peer must not leak its blocked sibling
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _node_streams(node: int):
    rng = np.random.default_rng(7)
    pool_h1 = rng.integers(0, 2**32, 200, dtype=np.uint64).astype(np.uint32)
    pool_h2 = rng.integers(0, 2**32, 200, dtype=np.uint64).astype(np.uint32)
    idx = np.arange(R) + node * 32
    return pool_h1[idx], pool_h2[idx], np.full(R, node + 1, np.int32)


def test_two_process_fleet_merge_equals_jax(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    port = _free_port()
    outs = _run_pair([[sys.executable, str(script), str(i), str(port)]
                      for i in range(2)], timeout=170)
    res = []
    for rc, out, err in outs:
        assert rc == 0, f"worker failed:\n{err[-3000:]}"
        res.append(json.loads(out.strip().splitlines()[-1]))
    assert {r["node"] for r in res} == {0, 1}
    streams = [_node_streams(i) for i in range(2)]
    h1, h2, c = (np.stack([s[j] for s in streams]) for j in range(3))
    cm, regs, total = jax_fleet.fleet_merge_sketches(h1, c,
                                                     mesh=jax_mesh(2))
    u1, u2, uc = jax_fleet.fleet_merge_exact64(h1, h2, c, mesh=jax_mesh(2))
    for r in res:  # every node holds the fleet's result
        assert r["total"] == total == 192
        assert r["cm"] == hashlib.sha256(cm.tobytes()).hexdigest()
        assert r["cm_dtype"] == str(cm.dtype)
        assert r["regs"] == regs.tolist()
        assert (r["u1"], r["u2"], r["uc"]) == (u1.tolist(), u2.tolist(),
                                               uc.tolist())
        assert r["dtypes"] == [str(a.dtype) for a in (u1, u2, uc)]
    assert len(u1) == 96
    # The merger's rounds agree fleet-wide. Round 1: node 0 gave 64 rows
    # of count 1, node 1 56 rows of count 2; round 2 node 0's 16 rows
    # alone (node 1's zero stream is the identity).
    r0, r1 = res[0]["rounds"], res[1]["rounds"]
    assert r0 == r1
    assert r0[0]["fleet_total_samples"] == 64 * 1 + 56 * 2
    assert r0[0]["fleet_rounds"] == 1
    assert r0[1] == {"fleet_total_samples": 16, "fleet_unique_stacks": 16,
                     "fleet_rounds": 2}


_JOIN = r"""
import sys, time
from parca_agent_tpu_torch.parallel.distributed import (
    FleetJoinError, fleet_initialize)

t0 = time.monotonic()
try:
    fleet_initialize(f"127.0.0.1:{sys.argv[1]}", num_nodes=2, node_id=1,
                     timeout_s=0.5, device="cpu")
except FleetJoinError as e:
    print("JOIN_ERROR", round(time.monotonic() - t0, 3), e, flush=True)
    sys.exit(0)
print("JOINED", flush=True)
sys.exit(1)
"""


def test_bounded_join_to_a_closed_port_raises(tmp_path):
    script = tmp_path / "join.py"
    script.write_text(_JOIN)
    p = subprocess.Popen([sys.executable, str(script), str(_free_port())],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, env=_env(), cwd=REPO)
    try:
        out, err = p.communicate(timeout=60)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    assert p.returncode == 0, out + err[-2000:]
    line = out.strip().splitlines()[0].split()
    assert line[0] == "JOIN_ERROR" and float(line[1]) < 5.0
    assert "did not complete within" in out


def test_join_on_the_card_without_one_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.fleet_initialize("127.0.0.1:1", 2, 1, timeout_s=0.5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.local_fleet_mesh()


# -- the merge actor's degrade/rejoin state machine --------------------------


class _Stub:
    """The merger's collectives stubbed: a hang (sleep past the bound) or
    an error on the first `n_bad` calls of `_merge_collective` or of the
    probe, then the numpy oracle of the merge (the width agreement, a
    world-of-one all_gather, still runs)."""

    def __init__(self, merger, hang_s=0.0, merge_errors=0, probe_errors=0):
        self.hang_s, self.merge_errors = hang_s, merge_errors
        self.probe_errors = probe_errors
        self.real_probe = merger._probe_collective
        merger._merge_collective = self.merge
        merger._probe_collective = self.probe

    def merge(self, h1, h2, counts):
        if self.hang_s:
            hang, self.hang_s = self.hang_s, 0.0
            time.sleep(hang)
        if self.merge_errors:
            self.merge_errors -= 1
            raise RuntimeError("injected fault")
        distributed._agree_width(len(h1),
                                 distributed.local_fleet_mesh("cpu"))
        key = (h1.astype(np.uint64) << np.uint64(32)) | h2
        uniq, inv = np.unique(key, return_inverse=True)
        sums = np.zeros(len(uniq), np.int64)
        np.add.at(sums, inv, counts.astype(np.int64))
        return ((uniq >> np.uint64(32)).astype(np.uint32),
                uniq.astype(np.uint32), sums.astype(np.int32))

    def probe(self):
        if self.probe_errors:
            self.probe_errors -= 1
            raise RuntimeError("injected fault")
        self.real_probe()


def _merger(**kw):
    return distributed.FleetWindowMerger(interval_s=0.0, device="cpu", **kw)


def _submit(m, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.integers(0, 2**32, 16, dtype=np.uint64).astype(np.uint32)
    m.submit_window((h, h), np.ones(16, np.int32))


def _wait(pred, timeout: float) -> bool:
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


def test_collective_timeout_degrades_then_rejoins():
    m = _merger(collective_timeout_s=0.1, rejoin_after_rounds=2)
    _Stub(m, hang_s=0.6)
    _submit(m, 1)
    m.merge_round()                      # wedged -> degraded
    assert m.degraded
    assert m.stats["collective_timeouts"] == 1
    assert m.fleet_stats == {}           # no bogus gauges from the hang
    _submit(m, 2)
    m.merge_round()                      # node-local only, counted
    assert m.stats["local_only_rounds"] == 1
    assert _wait(m._inflight_clear, timeout=10)
    for _ in range(4):
        m.merge_round()
        if not m.degraded:
            break
    assert not m.degraded
    assert m.stats["rejoins"] == 1
    _submit(m, 3)
    m.merge_round()                      # back on the schedule
    assert m.fleet_stats["fleet_rounds"] == 1
    assert m.fleet_stats["fleet_total_samples"] == 16
    assert m.failed is None


def test_collective_failure_degrades_instead_of_killing_fleet_mode():
    m = _merger(collective_timeout_s=5, rejoin_after_rounds=1)
    _Stub(m, merge_errors=1)
    _submit(m)
    m.merge_round()
    assert m.degraded and m.failed is None
    assert "injected fault" in m.last_degrade_error
    assert m.stats["collective_timeouts"] == 0
    m.merge_round()                      # the rejoin probe succeeds
    assert not m.degraded and m.stats["rejoins"] == 1


def test_failed_rejoin_probe_backs_off():
    m = _merger(collective_timeout_s=5, rejoin_after_rounds=1,
                max_rejoin_after_rounds=8)
    _Stub(m, merge_errors=1, probe_errors=2)
    m.merge_round()                      # degrade
    assert m.degraded
    m.merge_round()                      # the first probe fails
    assert m.stats["rejoin_probes_failed"] == 1
    assert m._rejoin_in == 2             # doubled backoff
    m.merge_round()
    m.merge_round()                      # the second probe fails
    assert m.stats["rejoin_probes_failed"] == 2
    assert m._rejoin_in == 4
    for _ in range(4):
        m.merge_round()
    assert not m.degraded and m.stats["rejoins"] == 1


def test_heartbeat_reports_stall_and_request_rejoin_pulls_forward():
    m = _merger(collective_timeout_s=None, rejoin_after_rounds=8)
    assert m.heartbeat()
    m.round_started_at = m._clock() - 1000  # a wedged unbounded round
    assert not m.heartbeat()
    m.round_started_at = None
    m.degraded = True
    m._rejoin_in = 8
    m.request_rejoin()
    assert m._rejoin_in == 1
    m.failed = RuntimeError("x")
    assert not m.heartbeat()


class _Hotspots:
    def __init__(self, fail=False):
        self.folds, self.degrades, self.fail = [], [], fail

    def fleet_fold(self, u1, u2, uc):
        if self.fail:
            raise RuntimeError("rollup trouble")
        self.folds.append(int(uc.sum()))

    def fleet_degraded(self, error):
        self.degrades.append(error)


def test_a_world_of_one_merges_its_own_window_and_feeds_hotspots():
    """No group formed: one node on the caller's device, the real merge
    (width agreement, exact merge) with no collective."""
    m = _merger(collective_timeout_s=5)
    store = _Hotspots()
    m.attach_hotspots(store)
    assert store.fleet_interval_s == 0.0
    rng = np.random.default_rng(3)
    h1 = rng.integers(0, 2**32, 100, dtype=np.uint64).astype(np.uint32)
    h2 = rng.integers(0, 2**32, 100, dtype=np.uint64).astype(np.uint32)
    h1[50:], h2[50:] = h1[:50], h2[:50]
    m.submit_window(lambda: (h1, h2), np.full(100, 2, np.int32))
    m.merge_round()
    assert m.fleet_stats == {"fleet_total_samples": 200,
                             "fleet_unique_stacks": 50, "fleet_rounds": 1}
    m.merge_round()                      # no window: the zero stream
    assert m.fleet_stats["fleet_unique_stacks"] == 0
    assert store.folds == [200, 0]
    m.attach_hotspots(_Hotspots(fail=True))  # best-effort rollup
    m.merge_round()
    assert m.fleet_stats["fleet_rounds"] == 3 and not m.degraded
    stop = threading.Event()
    t = threading.Thread(target=m.run, args=(stop,), daemon=True)
    t.start()
    assert _wait(lambda: m.fleet_stats["fleet_rounds"] >= 5, timeout=10)
    stop.set()
    t.join(10)
    assert not t.is_alive() and m.failed is None


# -- the CLI ---------------------------------------------------------------


def _cli(*flags, windows=2):
    return [sys.executable, "-m", "parca_agent_tpu_torch", "--device", "cpu",
            "--http-address", "127.0.0.1:0",
            "--windows", str(windows), "--profiling-duration", "0.2",
            *flags]


def test_cli_rejects_a_bad_node_spec():
    for spec in (["--fleet-nodes", "1", "--fleet-node-id", "0"],
                 ["--fleet-nodes", "2", "--fleet-node-id", "2"]):
        r = subprocess.run(_cli("--fleet-coordinator", "127.0.0.1:1", *spec),
                           env=_env(), cwd=REPO, capture_output=True,
                           text=True, timeout=120)
        assert r.returncode == 2, r.stdout + r.stderr
        assert "--fleet-nodes >= 2" in r.stderr


def test_cli_continues_single_node_after_a_failed_join():
    r = subprocess.run(
        _cli("--fleet-coordinator", f"127.0.0.1:{_free_port()}",
             "--fleet-nodes", "2", "--fleet-node-id", "1",
             "--fleet-join-timeout", "0.5"),
        env=_env(), cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "fleet join failed; continuing single-node" in r.stderr
    lines = [json.loads(x) for x in r.stdout.splitlines()]
    assert [x["window"] for x in lines if "window" in x] == [1, 2]
    assert not any("fleet" in x for x in lines)  # no fleet line


def test_cli_two_node_fleet_runs_merge_rounds():
    port = _free_port()
    outs = _run_pair([_cli("--fleet-coordinator", f"127.0.0.1:{port}",
                           "--fleet-nodes", "2", "--fleet-node-id", str(i),
                           "--collective-timeout", "20", "--fast-encode",
                           windows=3)
                      for i in range(2)], timeout=170)
    for rc, out, err in outs:
        assert rc == 0, err[-3000:]
        lines = [json.loads(x) for x in out.splitlines()]
        assert [x["window"] for x in lines if "window" in x] == [1, 2, 3]
        fleet = lines[-1]
        # The node that stops first leaves its peer's next round without a
        # partner: that peer may end degraded, never failed.
        assert fleet["failed"] is None
        assert fleet["fleet"]["fleet_rounds"] >= 1
        # A round merges at most one window of each node (10,000 stacks,
        # 1,000,000 samples a synthetic window, the same on both nodes).
        assert fleet["fleet"]["fleet_total_samples"] in (0, 1_000_000,
                                                         2_000_000)
        assert fleet["fleet"]["fleet_unique_stacks"] in (0, 10_000)
