"""The readers of the program's spans and counters (``program_spans``,
``metrics/{encode_issue_ms,step_issue_us,stop_sync_ms,stop_syncs}.py``) on
synthetic records: they read the last un-profiled records, one per batch
the harness's spans read, and give None where the records' steps differ
from the launches the harness counted, where there are no batches, or
where the program keeps no records."""

import sys
import types

import pytest

from benchmark import harness, program_spans
from p4fr_tpu_torch.utils import tracing

READERS = ("encode_issue_ms", "step_issue_us", "stop_sync_ms", "stop_syncs")


def record(call, steps, encode, decode, stop, profiled=False):
    return tracing.Record(call, "decode_images", profiled,
                          {"encode": encode, "decode": decode, "decode.stop_check": stop},
                          {"steps": steps, "stop_checks": steps})


def readings(steps):
    return types.SimpleNamespace(spans=[{"steps": s} for s in steps])


@pytest.fixture
def recs(monkeypatch):
    kept = [
        record(0, 10, 9.0, 9.0, 9.0),  # the warm batch, before the window
        record(1, 4, 0.010, 0.004, 0.002),
        record(2, 6, 0.030, 0.008, 0.004),
        record(3, 6, 5.0, 5.0, 5.0, profiled=True),  # the profiled sub-window
    ]
    monkeypatch.setattr(tracing, "records", lambda: list(kept))
    return kept


def test_the_readers_read_the_windows_records(recs):
    r = readings([4, 6])
    assert program_spans.window(r) == recs[1:3]
    read = {name: harness.read_metric(name, r) for name in READERS}
    assert read["encode_issue_ms"] == pytest.approx(20.0)  # (10 + 30) / 2 ms
    assert read["step_issue_us"] == pytest.approx(1e6 * (0.002 + 0.004) / 10)
    assert read["stop_sync_ms"] == pytest.approx(3.0)
    assert read["stop_syncs"] == pytest.approx(5.0)
    for name in READERS:  # the .early_stop twins read the same modules
        assert harness.read_metric(name + ".early_stop", r) == read[name]


@pytest.mark.parametrize("steps", [[4, 7], [6, 4], [], [1, 4, 6, 6]])
def test_none_where_the_steps_do_not_match(recs, steps):
    r = readings(steps)
    assert program_spans.window(r) is None
    for name in READERS:
        assert harness.read_metric(name, r) is None


def test_none_without_the_programs_records(recs, monkeypatch):
    import p4fr_tpu_torch.utils

    # as in a tree whose program has no utils/tracing.py
    monkeypatch.delattr(p4fr_tpu_torch.utils, "tracing")
    monkeypatch.setitem(sys.modules, "p4fr_tpu_torch.utils.tracing", None)
    r = readings([4, 6])
    for name in READERS:
        assert harness.read_metric(name, r) is None


def test_the_benchmark_lists_each_reader():
    import json
    import os

    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        per_layer = {m["name"]: m for m in json.load(f)["per_layer"]}
    assert {harness.base(n) for n in per_layer} >= set(READERS)
    assert per_layer["stop_syncs.early_stop"]["source"] == "program_counter"
    for name in ("encode_issue_ms", "step_issue_us"):
        assert per_layer[name]["workloads"] == [w.replace("lenlog35", "len231") for w in
                                                per_layer[name + ".early_stop"]["workloads"]]
