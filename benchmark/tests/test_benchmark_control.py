"""``correct`` comes out false where it should: a run with a fault planted
under the timed path (on the CPU at a tiny size, past the harness's look
for a card), and the fp8 control in the program's place (on the card, at
each cell's own size)."""

import json
import os

import pytest
import torch

import tiny
from benchmark import calibrate, check, faults, harness

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def limits(cell):
    with open(os.path.join(BENCH, "workloads", f"{cell}.json")) as f:
        return json.load(f)["limits"]


CELLS = [w["name"] for w in json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]]
TINY = {"effsatrn": tiny.EFFSATRN, "swintrn": tiny.SWINTRN}


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_makes_the_run_incorrect(cell, fault):
    spec = harness.load_spec(cell)
    small = tiny.spec(TINY[spec.work["config"]], spec.work["traffic"], limits=spec.work["limits"])
    sound = harness.run(small, 11, 2.5, False, "cpu", log=lambda *a: None)
    assert sound["correct"], sound["checks"]
    with faults.FAULTS[fault]():
        broken = harness.run(small, 11, 2.5, False, "cpu", log=lambda *a: None)
    assert not broken["correct"], broken["checks"]


def test_fp8_rounding():
    w = torch.randn(64, 32)
    q = check.fp8(w)
    assert torch.equal(check.fp8(q), q)
    rel = ((q - w).abs() / w.abs().amax(1, keepdim=True)).max()
    assert 0 < rel <= 2 ** -4


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_where_the_program_passes(cell, card):
    """The program and the fp8 control at the cell's own size, one seed."""
    spec = harness.load_spec(cell)
    got = calibrate.readings(spec, 2 ** 31 + 101, "cuda", control=True)
    lim = limits(cell)
    assert all(got[k] <= lim[k] for k in lim), got
    assert any(got[f"control_{k}"] > lim[k] for k in ("memory_rel_err", "logit_gap")), got
