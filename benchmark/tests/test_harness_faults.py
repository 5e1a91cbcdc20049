"""The output check fails a broken path: each cell's run driven on the
CPU at a small size (the look for a card skipped), once sound, once
with the control (the dict+cm path absorbing: the exact-count guarantee
broken) and once with each fault a cell can have planted under the
timed path. One chip runs each cell, so there is no exchange between
chips to leave out."""

import numpy as np
import pytest

from benchmark import control, manifest, run
from parca_agent_tpu_torch.aggregator.dict import DictAggregator

MAN = manifest.load()
SMALL = {"firehose-50k.steady": dict(pids=64, unique_stacks=2048,
                                     samples_per_window=10_000)}
CELLS = sorted(SMALL)
SEED = 2**31 + 4242


def small(cell_name):
    cell = manifest.cell(MAN, cell_name)
    cfg = dict(manifest.config(MAN, cell["config"]), **SMALL[cell_name])
    mix = dict(manifest.traffic(cell["traffic"]))
    if mix.get("churn_pids_per_window"):
        mix["churn_pids_per_window"] = 8
    return cell, cfg, mix


def evaluate(cell_name, cfg=None):
    cell, cfg0, mix = small(cell_name)
    line, _ = run.evaluate(MAN, cell, SEED, 1.0, False, device="cpu",
                           cfg=cfg or cfg0, mix=mix)
    return line


@pytest.mark.parametrize("cell_name", CELLS)
def test_a_sound_run_reads_correct(cell_name):
    line = evaluate(cell_name)
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"samples_per_s", "window_to_pprof_ms",
                                    "agent_cpu_s_per_msample", "setup_s"}
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("cell_name", CELLS)
def test_the_control_reads_incorrect(cell_name):
    _, cfg, _ = small(cell_name)
    try:
        line = evaluate(cell_name, control.control_config(cfg))
    except Exception:  # noqa: BLE001
        # A control that crashes has failed too: under host load the
        # dictionary's rotation can race the encode worker (the port's
        # window encoder indexes past its synced mirror) and the loop
        # raises the worker's error.
        return
    assert not line["correct"]
    assert line["checks"]["absorbed_samples"]["value"] > 0
    assert line["checks"]["mass_gap"]["value"] > 0


def _unchanged(orig):
    def feed(self, snapshot, hashes=None, lo=0, hi=None):
        return None          # the step leaves the window's state as it was
    return feed


def _half(orig):
    def feed(self, snapshot, hashes=None, lo=0, hi=None):
        hi = len(snapshot) if hi is None else hi
        return orig(self, snapshot, hashes, lo, lo + (hi - lo) // 2)
    return feed


def _altered(orig):
    def close_window(self, *a, **k):
        counts = orig(self, *a, **k)
        live = np.flatnonzero(np.asarray(counts))
        if len(live):
            counts = np.array(counts)
            counts[live[0]] += 1     # one count altered where it is made
        return counts
    return close_window


def _merged(orig):
    def close_window(self, *a, **k):
        counts = orig(self, *a, **k)
        live = np.flatnonzero(np.asarray(counts))
        if len(live) > 1:
            counts = np.array(counts)
            # Two stacks merged into one id, the window's mass kept: an
            # id collision, or a carry slot credited to the wrong stack.
            counts[live[0]] += counts[live[-1]]
            counts[live[-1]] = 0
        return counts
    return close_window


FAULTS = {"state_unchanged": ("feed", _unchanged),
          "half_the_batch": ("feed", _half),
          "answer_altered": ("close_window", _altered),
          "stacks_merged": ("close_window", _merged)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell_name", CELLS)
def test_a_broken_path_reads_incorrect(monkeypatch, cell_name, fault):
    attr, make = FAULTS[fault]
    monkeypatch.setattr(DictAggregator, attr,
                        make(getattr(DictAggregator, attr)))
    line = evaluate(cell_name)
    assert not line["correct"], line["checks"]
    assert line["failed"] >= 1
    if fault in ("answer_altered", "stacks_merged"):
        assert line["checks"]["window_count_gap"]["value"] > 0
