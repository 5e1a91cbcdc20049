"""The port's transport (agent/) held to parca_agent_tpu's.

The same inputs, made from a seed with ``random.Random``, go through both
packages: the WriteRaw codec, the batch client under one simulated clock,
recorded sleeps, one seeded jitter rng and a store that fails on a
scripted schedule, the spool's segment files, the chaos sites of the ship
path, the listener and the writers, the gRPC store client against an
in-process server, and the debuginfo upload client against a fake
debuginfo service. Every comparison is of bytes or exact values.

One difference is by design: the port's GRPCStoreClient sends a batch
over the channel's message cap as several requests under it (its module
docstring); ``test_batch_over_the_message_cap_*`` show where the two
part.
"""

from __future__ import annotations

import gzip
import os
import random
import threading
import time
from concurrent import futures

import pytest
import torch

from parca_agent_tpu.agent import batch as jax_batch
from parca_agent_tpu.agent import debuginfo_client as jax_dbg
from parca_agent_tpu.agent import grpc_client as jax_grpc
from parca_agent_tpu.agent import listener as jax_listener
from parca_agent_tpu.agent import profilestore as jax_ps
from parca_agent_tpu.agent import spool as jax_spool
from parca_agent_tpu.agent import writer as jax_writer
from parca_agent_tpu.utils import faults as jax_faults
from parca_agent_tpu_torch.agent import batch as port_batch
from parca_agent_tpu_torch.agent import debuginfo_client as port_dbg
from parca_agent_tpu_torch.agent import grpc_client as port_grpc
from parca_agent_tpu_torch.agent import listener as port_listener
from parca_agent_tpu_torch.agent import profilestore as port_ps
from parca_agent_tpu_torch.agent import spool as port_spool
from parca_agent_tpu_torch.agent import writer as port_writer
from parca_agent_tpu_torch.utils import faults as port_faults

torch.set_num_threads(1)

PACKAGES = {
    "jax": dict(batch=jax_batch, spool=jax_spool, ps=jax_ps, grpc=jax_grpc,
                listener=jax_listener, writer=jax_writer, faults=jax_faults,
                dbg=jax_dbg),
    "port": dict(batch=port_batch, spool=port_spool, ps=port_ps,
                 grpc=port_grpc, listener=port_listener, writer=port_writer,
                 faults=port_faults, dbg=port_dbg),
}


@pytest.fixture(autouse=True)
def _no_leaked_injector():
    yield
    jax_faults.install(None)
    port_faults.install(None)


def _install(spec: str, **kw) -> None:
    """The same fault rules in both packages' injectors."""
    jax_faults.install(jax_faults.FaultInjector.from_spec(spec, **kw))
    port_faults.install(port_faults.FaultInjector.from_spec(spec, **kw))


def _series(rng: random.Random, n: int, ps) -> list:
    """n seeded RawSeries of `ps` (a package's profilestore)."""
    out = []
    for i in range(n):
        labels = {"__name__": "parca_agent_cpu",
                  "pid": str(rng.randrange(1, 1 << 22))}
        for _ in range(rng.randrange(0, 4)):
            name = rng.choice(["comm", "node", "env", "cgroup_name", "é"])
            labels[name] = "".join(rng.choice("abcxyz/_-é")
                                   for _ in range(rng.randrange(0, 12)))
        samples = [rng.randbytes(rng.randrange(0, 300))
                   for _ in range(rng.randrange(1, 4))]
        out.append(ps.RawSeries(labels, samples))
    return out


def _plain(series) -> list:
    return [(dict(s.labels), list(s.samples)) for s in series]


# -- the WriteRaw codec -------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("normalized", [True, False])
def test_write_raw_request_bytes_equal(seed, normalized):
    jser = _series(random.Random(seed), 1 + seed * 7, jax_ps)
    pser = _series(random.Random(seed), 1 + seed * 7, port_ps)
    blob = port_ps.encode_write_raw_request(pser, normalized)
    assert blob == jax_ps.encode_write_raw_request(jser, normalized)
    got, norm = port_ps.decode_write_raw_request(blob)
    jgot, jnorm = jax_ps.decode_write_raw_request(blob)
    assert norm == jnorm == normalized
    assert _plain(got) == _plain(jgot) == _plain(pser)
    assert port_ps.decode_varint_prefixed(blob) == \
        jax_ps.decode_varint_prefixed(blob)


# -- the batch client ---------------------------------------------------------


class SimClock:
    """Simulated monotonic time, shared by the batch client and the spool;
    sleeps advance it and are recorded."""

    def __init__(self):
        self.now = 0.0
        self.sleeps: list[float] = []

    def __call__(self) -> float:
        return self.now

    def sleep(self, s: float) -> None:
        self.sleeps.append(s)
        self.now += s


class ScriptedStore:
    """Records every store call; the calls whose index is in `fail` raise."""

    def __init__(self, fail):
        self.fail = set(fail)
        self.calls: list = []

    def write_raw(self, series, normalized):
        i = len(self.calls)
        self.calls.append((_plain(series), normalized, i in self.fail))
        if i in self.fail:
            raise ConnectionError(f"scripted failure of call {i}")


# Each case exercises one of the batch client's paths: the byte-cap
# overflow spill, the spill after repeated failures, the counted drop
# with no spool, replay a few segments an interval, the retry budget the
# live flush and replay share, and the final drain after stop.
BATCH_CASES = {
    "overflow_spill": dict(spool=True, max_bytes=2_000, max_samples=10_000,
                           budget=8, replay=2, payload=(100, 700),
                           fail=lambda rng: set()),
    "failure_spill": dict(spool=True, max_bytes=1 << 20, max_samples=10_000,
                          budget=1, replay=4, payload=(10, 200),
                          fail=lambda rng: set(range(3, 14))),
    "drop_no_spool": dict(spool=False, max_bytes=1_500, max_samples=3,
                          budget=2, replay=4, payload=(50, 400),
                          fail=lambda rng: {i for i in range(40)
                                            if rng.random() < 0.3}),
    "replay_interval": dict(spool=True, max_bytes=900, max_samples=10_000,
                            budget=8, replay=1, payload=(100, 300),
                            fail=lambda rng: set(range(0, 6))),
    "shared_budget": dict(spool=True, max_bytes=1_200, max_samples=5,
                          budget=2, replay=8, payload=(50, 300),
                          fail=lambda rng: {i for i in range(60)
                                            if rng.random() < 0.7}),
    "final_drain": dict(spool=True, max_bytes=1 << 20, max_samples=10_000,
                        budget=3, replay=4, payload=(10, 100),
                        fail=lambda rng: set(range(6, 100)),
                        spool_max=2_000),
}


def _batch_ops(seed: int, payload) -> list:
    """A seeded run: writes under a few label sets, flushes, clock steps."""
    rng = random.Random(seed)
    ops = []
    for _ in range(60):
        r = rng.random()
        if r < 0.65:
            ops.append(("write", {"pid": str(rng.randrange(6)), "node": "n1"},
                        rng.randbytes(rng.randrange(*payload))))
        elif r < 0.85:
            ops.append(("flush",))
        else:
            ops.append(("advance", rng.choice([0.2, 1.0, 2.5, 10.0])))
    return ops


def _drive_batch(pkg: str, tmp, case: str, seed: int) -> dict:
    mods = PACKAGES[pkg]
    cfg = BATCH_CASES[case]
    clk = SimClock()
    spool = None
    if cfg["spool"]:
        spool = mods["spool"].SpoolDir(
            str(tmp), max_bytes=cfg.get("spool_max", 1 << 20), clock=clk)
    store = ScriptedStore(cfg["fail"](random.Random(seed)))
    c = mods["batch"].BatchWriteClient(
        store, interval_s=1.0, initial_backoff_s=0.05, clock=clk,
        sleep=clk.sleep, rng=random.Random(seed),
        max_buffer_bytes=cfg["max_bytes"],
        max_buffer_samples=cfg["max_samples"], spool=spool,
        spill_after_failures=2, retry_budget=cfg["budget"],
        replay_per_interval=cfg["replay"])
    flushes = []
    for op in _batch_ops(seed, cfg["payload"]):
        if op[0] == "write":
            c.write_raw(op[1], op[2])
        elif op[0] == "flush":
            flushes.append(c.flush())
        else:
            clk.now += op[1]
    c.stop()
    c.run()  # the final drain
    return {"calls": store.calls, "sleeps": clk.sleeps, "flushes": flushes,
            "stats": dict(c.stats), "sent": c.sent_batches,
            "errors": c.send_errors, "buffered": c.buffered(),
            "buffer_bytes": c.buffer_bytes(), "spool": c.spool_stats(),
            "backlog": c.replay_backlog(), "lag": c.replay_lag_s(),
            "segments": {n: (tmp / n).read_bytes()
                         for n in sorted(os.listdir(tmp))}}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", sorted(BATCH_CASES))
def test_batch_client_makes_the_same_store_calls(tmp_path, case, seed):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = _drive_batch("jax", tmp_path / "jax", case, seed)
    got = _drive_batch("port", tmp_path / "port", case, seed)
    assert got == want
    assert want["calls"], "the case made no store call"
    # Each case reaches the path it is named for.
    stats = want["stats"]
    reached = {"overflow_spill": stats["overflow_spills"],
               "failure_spill": stats["failure_spills"],
               "drop_no_spool": stats["samples_dropped"],
               "replay_interval": stats["segments_replayed"],
               "shared_budget": stats["retry_budget_exhausted"],
               "final_drain": want["spool"].get("segments_written", 0)}[case]
    assert reached > 0, (case, stats, want["spool"])


def test_batch_run_loop_drains_on_stop_alike():
    stores = {}
    for pkg, mods in PACKAGES.items():
        store = ScriptedStore(())
        c = mods["batch"].BatchWriteClient(store, interval_s=30.0)
        t = threading.Thread(target=c.run, daemon=True)
        t.start()
        c.write_raw({"pid": "9"}, b"z")
        c.stop()
        t.join(timeout=5)
        assert not t.is_alive()
        stores[pkg] = store.calls
    assert stores["port"] == stores["jax"] == [([({"pid": "9"}, [b"z"])],
                                                True, False)]


def test_noop_store_and_gauges_alike():
    for mods in PACKAGES.values():
        mods["batch"].NoopStoreClient().write_raw([], normalized=True)
    got = []
    for mods in PACKAGES.values():
        c = mods["batch"].BatchWriteClient(mods["batch"].NoopStoreClient(),
                                           interval_s=60)
        c.write_raw({"pid": "1"}, b"a")
        c.write_raw({"pid": "1"}, b"b")
        c.write_raw({"pid": "2"}, b"c")
        row = [c.buffered(), c.buffer_bytes(), c.replay_backlog(),
               c.replay_lag_s(), c.spool_stats()]
        assert c.flush()
        got.append(row + [c.buffered(), c.sent_batches])
    assert got[0] == got[1]
    assert got[0][0] == (2, 3)


# -- the spool ----------------------------------------------------------------


def _spools(tmp_path, **kw):
    out = {}
    for pkg, mods in PACKAGES.items():
        d = tmp_path / pkg
        d.mkdir(exist_ok=True)
        out[pkg] = (mods, d, mods["spool"].SpoolDir(str(d), **kw))
    return out


def _segment_bytes(d) -> dict:
    return {p.name: p.read_bytes() for p in sorted(d.glob("*.seg"))}


@pytest.mark.parametrize("seed", range(3))
def test_spool_segments_are_byte_equal(tmp_path, seed):
    spools = _spools(tmp_path)
    for pkg, (mods, d, sp) in spools.items():
        rng = random.Random(seed)
        for _ in range(4):
            assert sp.append(_series(rng, rng.randrange(1, 6), mods["ps"]))
    (_, jd, jsp), (_, pd_, psp) = spools["jax"], spools["port"]
    assert _segment_bytes(pd_) == _segment_bytes(jd)
    assert len(_segment_bytes(jd)) == 4
    assert psp.pending() == jsp.pending()
    assert psp.stats == jsp.stats
    # Replay reads them oldest first, in both.
    while True:
        j, p = jsp.read_oldest(), psp.read_oldest()
        assert (j is None) == (p is None)
        if j is None:
            break
        assert p[0] == j[0] and _plain(p[1]) == _plain(j[1])
        jsp.pop(j[0])
        psp.pop(p[0])
    assert psp.stats == jsp.stats


def test_spool_adoption_eviction_and_corruption_alike(tmp_path):
    counts = {}
    for pkg, (mods, d, sp) in _spools(tmp_path).items():
        rng = random.Random(7)
        for _ in range(3):
            sp.append(_series(rng, 3, mods["ps"]))
        (d / "000000000099.seg.tmp").write_bytes(b"torn")  # a crashed write
        (d / "000000000098.seg").write_bytes(b"not a segment")
        # A restart adopts the three, drops the torn and the bad file.
        sp2 = mods["spool"].SpoolDir(str(d))
        adopted = (sp2.pending(), dict(sp2.stats))
        # Flip the last byte of the second segment: its tail frame's CRC.
        seg = sorted(d.glob("*.seg"))[1]
        data = bytearray(seg.read_bytes())
        data[-1] ^= 0xFF
        seg.write_bytes(bytes(data))
        reads = []
        for _ in range(5):
            got = sp2.read_oldest()
            if got is None:
                break
            reads.append((got[0], _plain(got[1])))
            sp2.pop(got[0])
        # Past a byte cap of one segment the oldest go first.
        capped = mods["spool"].SpoolDir(str(tmp_path / f"cap-{pkg}"),
                                        max_bytes=600)
        rng = random.Random(8)
        for _ in range(4):
            capped.append(_series(rng, 2, mods["ps"]))
        counts[pkg] = (adopted, reads, dict(sp2.stats), capped.pending(),
                       dict(capped.stats),
                       sorted(os.listdir(tmp_path / f"cap-{pkg}")))
    assert counts["port"] == counts["jax"]
    assert counts["jax"][2]["corrupt_segments"] == 2  # the bad file, the flip
    assert counts["jax"][4]["segments_dropped"] > 0


# -- the chaos sites of the ship path -----------------------------------------


@pytest.mark.chaos
def test_spool_write_disk_full_counts_alike(tmp_path):
    _install("spool.write:disk_full:count=2", seed=0)
    stats = {}
    for pkg, (mods, d, sp) in _spools(tmp_path).items():
        rng = random.Random(3)
        ok = [sp.append(_series(rng, 2, mods["ps"])) for _ in range(3)]
        stats[pkg] = (ok, dict(sp.stats), sorted(os.listdir(d)))
    assert stats["port"] == stats["jax"]
    assert stats["jax"][0] == [False, False, True]


@pytest.mark.chaos
def test_batch_flush_site_counts_alike(tmp_path):
    out = {}
    for pkg, mods in PACKAGES.items():
        clk = SimClock()
        mods["faults"].install(mods["faults"].FaultInjector.from_spec(
            "batch.flush:error:count=2", seed=0, clock=clk, sleep=clk.sleep))
        store = ScriptedStore(())
        d = tmp_path / pkg
        sp = mods["spool"].SpoolDir(str(d), clock=clk)
        c = mods["batch"].BatchWriteClient(
            store, interval_s=10.0, clock=clk, sleep=clk.sleep,
            initial_backoff_s=0.01, retry_budget=4, spill_after_failures=1,
            spool=sp, rng=random.Random(0))
        c.write_raw({"pid": "1"}, b"a")
        out[pkg] = (c.flush(), c.send_errors, store.calls, clk.sleeps,
                    dict(c.stats), sp.pending(),
                    mods["faults"].get().stats())
    assert out["port"] == out["jax"]
    assert out["jax"][0] is True and out["jax"][1] == 2


class _FakeChannel:
    def __init__(self, shipped=None, fail=None):
        self.shipped = shipped if shipped is not None else []
        self.fail = fail

    def unary_unary(self, *a, **kw):
        def call(req, timeout=None, metadata=None):
            if self.fail is not None:
                raise self.fail()
            self.shipped.append(req)
            return b""
        return call

    def close(self):
        pass


class _FakeRpcError(Exception):
    def __init__(self, code, details=""):
        self._code, self._details = code, details

    def code(self):
        return self._code

    def details(self):
        return self._details

    def debug_error_string(self):
        return self._details


@pytest.mark.chaos
def test_grpc_write_raw_unavailable_resets_alike(monkeypatch):
    pytest.importorskip("grpc")
    _install("grpc.write_raw:unavailable:count=3", seed=0)
    out = {}
    for pkg, mods in PACKAGES.items():
        builds = []
        shipped = []
        client = mods["grpc"].GRPCStoreClient(
            "store.test:443", insecure_skip_verify=True,
            reset_after_unavailable=2)
        monkeypatch.setattr(client, "_build_channel",
                            lambda: builds.append(1) or _FakeChannel(shipped))
        errors = []
        for _ in range(4):
            try:
                client.write_raw([mods["ps"].RawSeries({"a": "1"}, [b"x"])],
                                 normalized=True)
            except mods["faults"].InjectedRpcError as e:
                errors.append(e.kind)
        out[pkg] = (errors, dict(client.stats), len(builds), shipped,
                    mods["faults"].get().stats())
    assert out["port"] == out["jax"]
    assert out["jax"][1]["channel_resets"] == 1 and out["jax"][2] == 2


@pytest.mark.chaos
def test_grpc_handshake_fault_absorbed_by_flush_alike():
    pytest.importorskip("grpc")
    _install("grpc.handshake:handshake:count=2", seed=0)
    out = {}
    for pkg, mods in PACKAGES.items():
        shipped = []

        class FakeGrpc:
            def insecure_channel(self, addr, options=None):
                return _FakeChannel(shipped)

        client = mods["grpc"].GRPCStoreClient("store.test:443", insecure=True)
        client._grpc = FakeGrpc()
        batch = mods["batch"].BatchWriteClient(client, retry_budget=0)
        batch.write_raw({"a": "1"}, b"x")
        flushes = [batch.flush() for _ in range(3)]
        out[pkg] = (flushes, batch.send_errors, batch.buffered(), shipped,
                    dict(client.stats), mods["faults"].get().stats())
    assert out["port"] == out["jax"]
    assert out["jax"][0] == [False, False, True] and len(out["jax"][3]) == 1


@pytest.mark.parametrize("kind", ["handshake", "unavailable", "exhausted"])
def test_grpc_failure_classifier_alike(monkeypatch, kind):
    grpc = pytest.importorskip("grpc")
    make = {"handshake": lambda: _FakeRpcError(
                grpc.StatusCode.UNAVAILABLE,
                "Ssl handshake failed: CERTIFICATE_VERIFY"),
            "unavailable": lambda: _FakeRpcError(
                grpc.StatusCode.UNAVAILABLE, "connection refused"),
            "exhausted": lambda: _FakeRpcError(
                grpc.StatusCode.RESOURCE_EXHAUSTED, "message too large")}[kind]
    out = {}
    for pkg, mods in PACKAGES.items():
        builds = []
        client = mods["grpc"].GRPCStoreClient(
            "store.test:443", insecure_skip_verify=True,
            reset_after_unavailable=3)
        monkeypatch.setattr(client, "_build_channel",
                            lambda: builds.append(1)
                            or _FakeChannel(fail=make))
        for _ in range(5):
            with pytest.raises(_FakeRpcError):
                client.write_raw([mods["ps"].RawSeries({"a": "1"}, [b"x"])],
                                 normalized=True)
        insecure = mods["grpc"].GRPCStoreClient("store.test:80", insecure=True)
        insecure._note_rpc_failure(make())
        out[pkg] = (dict(client.stats), len(builds),
                    client._consec_unavailable, dict(insecure.stats))
    assert out["port"] == out["jax"]


def test_grpc_helpers_alike():
    for addr in ("host.example:7070", "host.example", "host.example:",
                 "[2001:db8::1]", "[2001:db8::1]:7070", "[2001:db8::1]:",
                 "host:notaport"):
        assert port_grpc._split_host_port(addr) == \
            jax_grpc._split_host_port(addr)
    assert port_grpc._cert_name("not a pem") == \
        jax_grpc._cert_name("not a pem") == ""
    assert port_grpc.WRITE_RAW_METHOD == jax_grpc.WRITE_RAW_METHOD
    assert port_grpc.MAX_MSG_BYTES == jax_grpc.MAX_MSG_BYTES


# -- the listener and the writers ---------------------------------------------


def test_listener_tee_and_matching_alike():
    got = {}
    for pkg, mods in PACKAGES.items():
        store = ScriptedStore(())
        batch = mods["batch"].BatchWriteClient(store)
        listener = mods["listener"].MatchingProfileListener(next_writer=batch)
        hit = {}

        def wait():
            hit["r"] = listener.next_matching_profile(
                mods["listener"].equals_matcher(pid="7"), timeout=5)

        t = threading.Thread(target=wait)
        t.start()
        deadline = time.monotonic() + 5
        while not listener._observers and time.monotonic() < deadline:
            time.sleep(0.01)
        listener.write_raw({"pid": "6"}, b"no")
        listener.write_raw({"pid": "7"}, b"yes")
        t.join(timeout=5)
        assert not t.is_alive()
        assert batch.flush()
        timed_out = listener.next_matching_profile(lambda _: True,
                                                   timeout=0.05)
        got[pkg] = (hit["r"], store.calls, timed_out, listener._observers)
    assert got["port"] == got["jax"]
    assert got["jax"][0] == ({"pid": "7"}, b"yes")


def test_writers_alike(tmp_path):
    out = {}
    for pkg, mods in PACKAGES.items():
        w = mods["writer"]
        d = tmp_path / pkg
        fw = w.FileProfileWriter(str(d))
        fw.write_raw({"__name__": "cpu", "comm": "app", "pid": "3"}, b"gz")
        seen = []

        class Sink:
            def write_raw(self, labels, sample):
                seen.append((labels, gzip.decompress(sample)))

        listener = mods["listener"].MatchingProfileListener(Sink())
        tee = w.TeeProfileWriter(fw, w.RemoteProfileWriter(listener))
        tee.write({"pid": "4", "node": "a/b"}, memoryview(b"raw-pprof"))
        files = sorted(d.iterdir())
        out[pkg] = ([f.name.split(".")[0] for f in files],
                    [gzip.decompress(f.read_bytes()) if f.name.startswith(
                        "node") else f.read_bytes() for f in files], seen)
    assert out["port"] == out["jax"]
    assert out["jax"][0] == ["comm=app_pid=3", "node=a-b_pid=4"]
    assert out["jax"][2] == [({"pid": "4", "node": "a/b"}, b"raw-pprof")]


@pytest.mark.chaos
def test_file_writer_disk_full_alike(tmp_path):
    _install("writer.write:disk_full:count=1", seed=0)
    out = {}
    for pkg, mods in PACKAGES.items():
        d = tmp_path / pkg
        w = mods["writer"].FileProfileWriter(str(d))
        with pytest.raises(OSError):
            w.write_raw({"pid": "1"}, b"gz")
        empty = list(d.iterdir())
        w.write_raw({"pid": "1"}, b"gz")
        (f,) = list(d.iterdir())
        out[pkg] = (empty, f.read_bytes(), mods["faults"].get().stats())
    assert out["port"] == out["jax"] == ([], b"gz", {"writer.write": 1})


# -- the gRPC store client against an in-process server -----------------------


def _write_raw_server(grpc, max_bytes: int | None = None):
    """An in-process WriteRaw handler recording each request's bytes and
    its authorization metadata. Returns (server, port, received)."""
    received = []

    def handler(request, context):
        md = dict(context.invocation_metadata())
        received.append((request, md.get("authorization", "")))
        return b""

    svc, method = port_grpc.WRITE_RAW_METHOD.lstrip("/").rsplit("/", 1)
    options = ([("grpc.max_receive_message_length", max_bytes)]
               if max_bytes else [])
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=2),
                         options=options)
    server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(
        svc, {method: grpc.unary_unary_rpc_method_handler(
            handler, request_deserializer=lambda b: b,
            response_serializer=lambda b: b)}),))
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()
    return server, port, received


@pytest.mark.parametrize("seed", [0, 1])
def test_grpc_loopback_request_bytes_equal(seed):
    grpc = pytest.importorskip("grpc")
    server, port, received = _write_raw_server(grpc)
    try:
        got = {}
        for pkg, mods in PACKAGES.items():
            client = mods["grpc"].GRPCStoreClient(
                f"127.0.0.1:{port}", insecure=True, bearer_token="tok",
                timeout_s=10)
            client.write_raw(_series(random.Random(seed), 5, mods["ps"]),
                             normalized=True)
            client.close()
            got[pkg] = received.pop()
    finally:
        server.stop(0)
    assert got["port"] == got["jax"]
    assert got["port"][1] == "Bearer tok"
    series, normalized = port_ps.decode_write_raw_request(got["port"][0])
    assert normalized and _plain(series) == \
        _plain(_series(random.Random(seed), 5, port_ps))


def test_batch_over_the_message_cap_is_split_by_the_port():
    """A batch whose request passes the cap: the original's client fails
    it on its own side (RESOURCE_EXHAUSTED) at every attempt; the port's
    sends it as requests under the cap, series by series, and the store
    receives every series once, in order."""
    grpc = pytest.importorskip("grpc")
    cap = 4_096
    server, port, received = _write_raw_server(grpc)
    try:
        results = {}
        for pkg, mods in PACKAGES.items():
            series = _series(random.Random(5), 40, mods["ps"])
            assert len(mods["ps"].encode_write_raw_request(series)) > cap
            client = mods["grpc"].GRPCStoreClient(
                f"127.0.0.1:{port}", insecure=True, timeout_s=10,
                max_msg_bytes=cap)
            try:
                client.write_raw(series, normalized=True)
                results[pkg] = "sent"
            except grpc.RpcError as e:
                results[pkg] = e.code()
            client.close()
            results[pkg + "_requests"] = [r for r, _ in received]
            received.clear()
    finally:
        server.stop(0)
    assert results["jax"] == grpc.StatusCode.RESOURCE_EXHAUSTED
    assert results["jax_requests"] == []
    assert results["port"] == "sent"
    reqs = results["port_requests"]
    assert len(reqs) > 1 and max(map(len, reqs)) <= cap
    shipped = [s for r in reqs for s in port_ps.decode_write_raw_request(r)[0]]
    assert _plain(shipped) == _plain(_series(random.Random(5), 40, port_ps))
    assert reqs == port_grpc.write_raw_requests(
        _series(random.Random(5), 40, port_ps), True, cap)


def test_batch_over_the_message_cap_replays_in_the_port_only(tmp_path):
    """The batch client caps its buffer at the message cap by payload and
    label bytes, without the framing: a spilled full buffer encodes past
    the cap. Its replay never ships through the original's client (the
    segment stays, replay_errors grows); the port's replays it."""
    grpc = pytest.importorskip("grpc")
    cap = 4_096
    server, port, received = _write_raw_server(grpc)
    try:
        out = {}
        for pkg, mods in PACKAGES.items():
            clk = SimClock()
            sp = mods["spool"].SpoolDir(str(tmp_path / pkg), clock=clk)
            client = mods["grpc"].GRPCStoreClient(
                f"127.0.0.1:{port}", insecure=True, timeout_s=10,
                max_msg_bytes=cap)
            c = mods["batch"].BatchWriteClient(
                client, interval_s=1.0, clock=clk, sleep=clk.sleep,
                rng=random.Random(0), max_buffer_bytes=cap, spool=sp)
            rng = random.Random(9)
            for i in range(60):  # a buffer and a half: one spill
                c.write_raw({"pid": str(i), "node": "n"}, rng.randbytes(90))
            flushes = [c.flush() for _ in range(3)]
            client.close()
            out[pkg] = (flushes, dict(c.stats), sp.pending(),
                        sum(len(port_ps.decode_write_raw_request(r)[0])
                            for r, _ in received))
            received.clear()
    finally:
        server.stop(0)
    assert out["jax"][1]["overflow_spills"] == 1
    assert out["port"][1]["overflow_spills"] == 1
    assert out["jax"][1]["replay_errors"] == 3 and out["jax"][2][0] == 1
    assert out["port"][1]["replay_errors"] == 0 and out["port"][2] == (0, 0)
    assert out["port"][1]["samples_replayed"] > 0
    assert out["port"][3] == 60 > out["jax"][3]


# -- the debuginfo upload client ----------------------------------------------


def _debuginfo_server(grpc):
    """A fake debuginfo service recording (method, request bytes) of every
    message, in order. Returns (server, port, log)."""
    from parca_agent_tpu_torch.pprof.proto import (
        iter_fields,
        put_tag_bytes,
        put_tag_varint,
    )

    log = []
    have = set()

    def fields(data):
        return {f: v for f, _w, v in iter_fields(data)}

    def should_initiate(request, context):
        log.append(("should", request))
        out = bytearray()
        put_tag_varint(out, 1, 0 if fields(request)[1] in have else 1)
        return bytes(out)

    def initiate(request, context):
        log.append(("initiate", request))
        build_id = fields(request)[1]
        instr = bytearray()
        put_tag_bytes(instr, 1, build_id)
        put_tag_bytes(instr, 2, b"up-" + build_id[:6])
        out = bytearray()
        put_tag_bytes(out, 1, bytes(instr))
        return bytes(out)

    def upload(request_iterator, context):
        for req in request_iterator:
            log.append(("upload", req))
        return b""

    def mark(request, context):
        log.append(("mark", request))
        have.add(fields(request)[1])
        return b""

    def unary(fn):
        return grpc.unary_unary_rpc_method_handler(
            fn, request_deserializer=lambda b: b,
            response_serializer=lambda b: b)

    name = port_dbg.SHOULD_INITIATE.rsplit("/", 1)[0].lstrip("/")
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
    server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(
        name, {
            port_dbg.SHOULD_INITIATE.rsplit("/", 1)[1]: unary(should_initiate),
            port_dbg.INITIATE.rsplit("/", 1)[1]: unary(initiate),
            port_dbg.UPLOAD.rsplit("/", 1)[1]:
                grpc.stream_unary_rpc_method_handler(
                    upload, request_deserializer=lambda b: b,
                    response_serializer=lambda b: b),
            port_dbg.MARK_FINISHED.rsplit("/", 1)[1]: unary(mark),
        }),))
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()
    return server, port, log


def test_debuginfo_client_sends_the_same_requests():
    grpc = pytest.importorskip("grpc")
    payload = b"\x7fELF" + random.Random(2).randbytes(2_500_000)  # 3 chunks
    logs = {}
    for pkg, mods in PACKAGES.items():
        server, port, log = _debuginfo_server(grpc)
        try:
            channel = grpc.insecure_channel(f"127.0.0.1:{port}")
            client = mods["dbg"].GRPCDebuginfoClient(lambda: channel,
                                                     timeout_s=10)
            bid = "ab" * 20
            answers = [client.exists(bid, "h1")]
            client.upload(bid, "h1", payload)
            answers.append(client.exists(bid, "h1"))
            answers.append(client.exists("cd" * 20, "h2"))
            channel.close()
        finally:
            server.stop(0)
        logs[pkg] = (answers, log)
    assert logs["port"] == logs["jax"]
    answers, log = logs["port"]
    assert answers == [False, True, False]
    assert [m for m, _ in log] == ["should", "initiate", "upload", "upload",
                                   "upload", "upload", "mark", "should",
                                   "should"]
    from parca_agent_tpu_torch.pprof.proto import iter_fields

    chunks = [v for m, r in log if m == "upload"
              for f, _w, v in iter_fields(r) if f == 2]
    assert b"".join(chunks) == payload


def test_debuginfo_codec_alike():
    for fn in ("_enc_should_initiate", "_enc_mark_finished",
               "_enc_upload_info"):
        assert getattr(port_dbg, fn)("b" * 40, "h") == \
            getattr(jax_dbg, fn)("b" * 40, "h")
    assert port_dbg._enc_initiate("b" * 40, "h", 12345) == \
        jax_dbg._enc_initiate("b" * 40, "h", 12345)
    assert port_dbg._enc_upload_chunk(b"xyz") == \
        jax_dbg._enc_upload_chunk(b"xyz")
    resp = jax_dbg._enc_upload_info("b" * 40, "upload-7")
    assert port_dbg._dec_initiate_upload_id(resp) == \
        jax_dbg._dec_initiate_upload_id(resp) == "upload-7"
    for data in (b"", b"\x08\x00", b"\x08\x01"):
        assert port_dbg._dec_should_initiate(data) == \
            jax_dbg._dec_should_initiate(data)
