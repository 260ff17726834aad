"""The harness: its files load and keep the contract's names, later files
are found by name, nothing imports the JAX side, a run on the CPU at a tiny
size completes and is correct, the CLI refuses without a card, and the
trace reader reads a profiler trace."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

import tiny
from benchmark import harness, trace

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_keys():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and 1 <= b["run_seconds"] <= 51
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}


def test_names_and_units():
    b = bench()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in b["workloads"]]:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if harness.base(m["name"]).endswith("_roofline_pct") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_every_file_of_a_cell_loads(cell):
    spec = harness.load_spec(cell)
    assert spec.config["network"] in ("EfficientSATRN", "SWIN")
    assert set(spec.work["limits"]) >= {"memory_rel_err", "logit_gap", "banned_picks"}
    for name in spec.per_layer:
        module = __import__(f"benchmark.metrics.{harness.base(name)}", fromlist=["read"])
        assert callable(module.read)
    assert "setup_s" in spec.end_to_end and len(spec.end_to_end) >= 2
    assert {harness.base(n) for n in spec.end_to_end} == {"images_per_s", "latency_p95_ms",
                                                          "setup_s"}
    traffic = harness.make_traffic(spec, 3)
    assert traffic.lengths.shape == (spec.work["pool"] // spec.work["batch"], spec.work["batch"])
    # every end-to-end metric a per-layer metric moves is reported in its cells
    for m in bench()["per_layer"]:
        if cell in m.get("workloads", [cell]):
            assert m["moves"] in spec.end_to_end


def test_a_dropped_in_file_is_found_by_name(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    b["workloads"].append({"name": "x.cell", "config": "effsatrn", "traffic": "short",
                           "chips": 1, "why": "a later cell"})
    b["per_layer"].append({"name": "zero_ms", "unit": "ms", "better": "lower",
                           "source": "program_span", "layer": "device",
                           "moves": "images_per_s", "workloads": ["x.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    short = dict(tiny.traffic("lenlog35"), median=4)
    (tmp_path / "benchmark/traffic/short.json").write_text(json.dumps(short))
    (tmp_path / "benchmark/workloads/x.cell.json").write_text(json.dumps(
        dict(harness.load_spec("effsatrn.fused.lenlog35.b256").work, batch=4, pool=16)))
    (tmp_path / "benchmark/metrics/zero_ms.py").write_text("def read(r):\n    return 0.5\n")
    code = ("from benchmark import harness\n"
            "s = harness.load_spec('x.cell')\n"
            "t = harness.make_traffic(s, 1)\n"
            "print(s.per_layer, harness.read_metric('zero_ms', None), t.lengths.shape)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "['zero_ms'] 0.5 (4, 4)"


def top_level_imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_nothing_imports_the_jax_side():
    for dirpath, _, files in os.walk(BENCH):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            names = set(top_level_imports(path))
            assert not names & set(harness.FORBIDDEN), path
            if os.sep + "reference" in path:
                assert "p4fr_tpu_torch" not in names, path
    assert harness.forbidden_modules() == [] or "jax" in sys.modules


@pytest.mark.parametrize("traffic_name", ["len231", "lenlog35"])
@pytest.mark.parametrize("config", [tiny.EFFSATRN, tiny.SWINTRN], ids=["effsatrn", "swintrn"])
def test_a_run_on_the_cpu_is_correct(config, traffic_name):
    result = harness.run(tiny.spec(config, traffic_name), 2 ** 31 + 5, 2.5, False, "cpu",
                         log=lambda *a: None)
    assert result["correct"], result["checks"]
    assert result["attempted"] == 8 * result["batches"] and result["batches"] >= 2
    assert result["batches"] % 2 == 0  # whole cycles of the pool's two batches
    assert set(result["metrics"]) == {"images_per_s", "latency_p95_ms", "setup_s"}


def test_the_cli_refuses_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    cmd = [sys.executable, "-m", "benchmark.run", "--workload", "effsatrn.fused.len231.b256",
           "--seed", "1", "--seconds", "1", "--trace", "0"]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    # a checkout of the benchmark alone, without the program, gives no result either
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def test_trace_reader():
    """A synthetic Chrome trace: kernels attributed by their launch call's
    host time, busy time as the union, idle gaps by the host's span."""
    ev = []

    def span(name, ts, dur):
        ev.append({"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur})

    def kernel(name, ts, dur, launch, corr):
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
                   "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": launch,
                   "dur": 1, "args": {"correlation": corr}})

    span("batch", 0, 100)
    span("feed", 0, 10)
    span("entry", 10, 80)
    span("encode", 10, 20)
    span("fetch", 90, 10)
    kernel("enc", 12, 20, 11, 1)
    kernel("dec", 35, 30, 31, 2)
    kernel("dec", 60, 20, 32, 3)  # overlaps the previous one
    t = trace.Trace(ev)
    assert t.window() == (0, 100)
    assert [k[0] for k in t.issued_by("entry", exclude="encode")] == ["dec", "dec"]
    assert [k[0] for k in t.issued_by("encode")] == ["enc"]
    assert t.busy_us(0, 100) == 20 + 45
    gaps = t.idle_gaps(0, 100)
    assert gaps == pytest.approx({"feed": 10e-6, "encode": 2e-6, "decode": 13e-6, "fetch": 10e-6})
    assert t.top_kernels(0, 100)[0] == ["dec", 50e-6]
    assert trace.device_seconds(t.issued_by("entry")) == pytest.approx(70e-6)
    assert np.isclose(sum(gaps.values()) * 1e6 + t.busy_us(0, 100), 100)
