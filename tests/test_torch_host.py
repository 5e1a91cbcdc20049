"""Two host hot spots of the port, fixed bit for bit.

`MappingTable.rows_for_pid` searches the int32 pid column with the pid
cast to the column's dtype (a Python int made numpy cast the whole
column on every search); `DictAggregator._register_stacks_bulk` groups
a batch's rows by pid with one stable sort (it scanned every row once a
pid). Both must answer exactly as parca_agent_tpu's copies do.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from parca_agent_tpu.aggregator.dict import DictAggregator as JaxDict
from parca_agent_tpu.capture import formats as jax_formats
from parca_agent_tpu.capture.synthetic import SyntheticSpec as JaxSpec
from parca_agent_tpu.capture.synthetic import generate as jax_generate
from parca_agent_tpu_torch.aggregator.dict import DictAggregator
from parca_agent_tpu_torch.capture import formats
from parca_agent_tpu_torch.capture.synthetic import SyntheticSpec, generate

torch.set_num_threads(1)

I32 = np.iinfo(np.int32)


def _tables():
    kw = dict(pids=[I32.min, -3, 0, 5, 5, 7, 7, 7, I32.max],
              starts=[0x10, 0x10, 0x10, 0x10, 0x100, 0x10, 0x100, 0x1000,
                      0x10],
              ends=[0x20, 0x20, 0x20, 0x20, 0x200, 0x20, 0x200, 0x2000,
                    0x20],
              offsets=[0] * 9, objs=[0] * 9, obj_paths=("/bin/a",))
    return jax_formats.MappingTable(**kw), formats.MappingTable(**kw)


@pytest.mark.parametrize("kind", [int, np.int32, np.int64])
def test_rows_for_pid_equal_for_every_pid_type(kind):
    jt, pt = _tables()
    pids = [I32.min, I32.min + 1, -3, -1, 0, 1, 5, 6, 7, 8, I32.max - 1,
            I32.max]
    if kind is not np.int32:
        pids += [I32.min - 1, I32.max + 1, -(2**40), 2**40]
    for pid in pids:
        got = pt.rows_for_pid(kind(pid))
        want = jt.rows_for_pid(int(pid))
        np.testing.assert_array_equal(got, want, err_msg=str(pid))
        assert got.dtype == want.dtype


def test_rows_for_pid_on_an_empty_table():
    t = formats.MappingTable(pids=[], starts=[], ends=[], offsets=[],
                             objs=[], obj_paths=())
    assert len(t.rows_for_pid(5)) == 0
    assert len(t.rows_for_pid(np.int64(2**40))) == 0


def _shuffled(snap, seed):
    perm = np.random.default_rng(seed).permutation(len(snap))
    return dataclasses.replace(
        snap, pids=snap.pids[perm], tids=snap.tids[perm],
        counts=snap.counts[perm], user_len=snap.user_len[perm],
        kernel_len=snap.kernel_len[perm], stacks=snap.stacks[perm])


def _assert_same_registries(jd, pd_):
    n = pd_._next_id
    assert n == jd._next_id
    np.testing.assert_array_equal(pd_._id_pid[:n], jd._id_pid[:n])
    np.testing.assert_array_equal(pd_._loc_off[:n + 1], jd._loc_off[:n + 1])
    nl = int(pd_._loc_off[n])
    np.testing.assert_array_equal(pd_._loc_flat[:nl], jd._loc_flat[:nl])
    assert list(pd_._pids) == list(jd._pids)
    for pid, pr in pd_._pids.items():
        jr = jd._pids[pid]
        assert pr.addr_to_loc == jr.addr_to_loc
        assert list(pr.addr_to_loc) == list(jr.addr_to_loc)
        for f in ("loc_address", "loc_normalized", "loc_mapping_id",
                  "loc_is_kernel"):
            assert [int(x) for x in getattr(pr, f)] \
                == [int(x) for x in getattr(jr, f)], (pid, f)
        assert [(m.id, m.start, m.end, m.offset, m.path, m.build_id, m.base)
                for m in pr.mappings] \
            == [(m.id, m.start, m.end, m.offset, m.path, m.build_id, m.base)
                for m in jr.mappings]
        assert pr.mapping_index == jr.mapping_index


@pytest.mark.parametrize("seed", [1, 2])
def test_register_stacks_bulk_interleaved_pids_equal_jax(seed):
    """Hundreds of pids, rows in random order (every pid's rows spread
    over the batch); a second window brings new stacks of known pids
    (registries that already hold addresses) and new pids."""
    kw = dict(n_pids=300, n_unique_stacks=3000, n_rows=3000,
              total_samples=20_000, mean_depth=12, kernel_fraction=0.2,
              seed=seed)
    kw2 = dict(kw, n_pids=400, n_unique_stacks=5000, n_rows=5000,
               seed=seed + 50)
    jd = JaxDict(capacity=1 << 14, overflow="raise")
    pd_ = DictAggregator(capacity=1 << 14, overflow="raise", device="cpu")
    for k in (kw, kw2):
        js = _shuffled(jax_generate(JaxSpec(**k)), seed)
        ps = _shuffled(generate(SyntheticSpec(**k)), seed)
        np.testing.assert_array_equal(np.asarray(jd.window_counts(js)),
                                      pd_.window_counts(ps))
        _assert_same_registries(jd, pd_)
    assert len(pd_._pids) > 300


def test_cold_window_tool_on_the_cpu(capsys):
    """tools/cold_window.py, which times A0's cold window: at a small
    spec on the CPU it prints one JSON line, and with --invalidate the
    long-lived encoder's bytes equal a fresh one's (the tool raises if
    not) while it builds no statics for the surviving pids."""
    import json

    from parca_agent_tpu_torch.tools import cold_window

    assert cold_window.main(["--device", "cpu", "--rows", "2048",
                             "--pids", "40", "--capacity", str(1 << 13),
                             "--encode", "--invalidate", "3"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["rows"] == out["inserts"] == 2048
    assert out["device"] == "cpu" and out["registry_epoch"] == 3
    assert out["encode_pids"] == 40
    assert out["encode_after_stats"]["statics_bytes_built"] == 0
    assert out["encode_after_stats"]["statics_cache_hits"] == 6
