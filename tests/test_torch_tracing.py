"""The port's spans and counters (``p4fr_tpu_torch/utils/tracing.py``).

- spans nest and add into the record of the entry call around them, a
  call inside another entry's call adds to its record, and the kept
  records stay within ``KEEP``;
- with no profiler recording, the inference path enters no
  ``record_function`` (it is patched to raise);
- under a CPU ``utils/system.py::profile_trace``, the exported trace holds
  the program's spans;
- ``stop_check`` returns what ``bool(done.all())`` returns, and counts;
- a tiny decode (greedy through the fused step's twin and through the
  shared greedy loop, and beam) gives one record whose ``steps`` and
  ``stop_checks`` are the steps it ran, with the same tokens whether or
  not a profiler records;
- on the card (``cuda``: ``python -m pytest --noconftest -m cuda
  tests/test_torch_tracing.py``), every launch of the fused step lies
  inside a ``decode.step`` of the profiler's trace and every host sync of
  the decode inside a ``decode.stop_check``.

The tiny EfficientSATRN is built with torch's own initialisation; no JAX.
"""

import json
import time

import pytest
import torch

from p4fr_tpu_torch.data.vocab import TOKENS_PATH, Vocab
from p4fr_tpu_torch.decoding import beam, fast_step, fused_greedy
from p4fr_tpu_torch.decoding.manager import RuleTables
from p4fr_tpu_torch.infer.single import beam_decode_images, build_fast, decode_images
from p4fr_tpu_torch.models.registry import get_network
from p4fr_tpu_torch.utils import system, tracing

STAGES = [[1, 3, 1, 1, 24, 24, False, True], [1, 3, 2, 4, 24, 32, False, True],
          [2, 3, 2, 4, 32, 48, True, False]]
CONFIG = {
    "network": "EfficientSATRN", "input_size": {"height": 32, "width": 64},
    "SATRN": {"encoder": {"hidden_dim": 32, "filter_dim": 32, "layer_num": 1, "head_num": 4,
                          "backbone_stages": STAGES},
              "decoder": {"src_dim": 32, "hidden_dim": 32, "filter_dim": 64, "layer_num": 2,
                          "head_num": 1}},
    "data": {"rgb": 3}, "dropout_rate": 0.0, "tpu": {"reference_parity": True},
}
STEPS = 12
STOPS = [2, 5, 3, 4]  # stop_override: row i is done once t >= STOPS[i]


@pytest.fixture(scope="module")
def tiny():
    torch.manual_seed(0)
    vocab = Vocab.from_files([TOKENS_PATH])
    model = get_network(CONFIG["network"], CONFIG, vocab, dtype=torch.float32,
                        device="cpu").eval()
    images = torch.randint(0, 256, (len(STOPS), 32, 64, 3),
                           generator=torch.Generator().manual_seed(1), dtype=torch.uint8)
    return vocab, model, build_fast(model), RuleTables.build(vocab, "cpu"), images


@pytest.fixture(autouse=True)
def fresh():
    tracing.reset()
    yield
    tracing.reset()


@tracing.entry("outer")
def outer(inner_calls=1):
    with tracing.span("a"):
        with tracing.span("a.b"):
            time.sleep(0.002)
        for _ in range(inner_calls):
            inner()
    tracing.count("steps", 3)


@tracing.entry("inner")
def inner():
    with tracing.span("a.b"):
        time.sleep(0.001)
    tracing.count("steps")


def test_spans_nest_and_add_into_the_record():
    outer(inner_calls=2)
    inner()
    first, second = tracing.records()
    assert (first.entry, second.entry) == ("outer", "inner")
    assert second.call > first.call and not first.profiled
    # the inner entry's calls joined the outer record
    assert first.counts == {"steps": 5, "stop_checks": 0}
    assert first.spans["a.b"] >= 0.004
    assert first.spans["a"] >= first.spans["a.b"]
    assert second.counts["steps"] == 1 and second.spans["a.b"] >= 0.001
    assert tracing.current() is None
    with tracing.span("a"):  # outside an entry: nothing is recorded
        pass
    assert len(tracing.records()) == 2


def test_a_failing_call_closes_its_record():
    @tracing.entry("boom")
    def boom():
        with tracing.span("a"):
            raise ValueError("boom")

    with pytest.raises(ValueError):
        boom()
    assert tracing.current() is None
    (rec,) = tracing.records()
    assert rec.entry == "boom" and "a" in rec.spans


def test_records_stay_within_their_bound():
    assert tracing.KEEP >= 8192
    call = tracing.entry("e")(lambda: None)
    for _ in range(tracing.KEEP + 5):
        call()
    recs = tracing.records()
    assert len(recs) == tracing.KEEP
    assert [r.call for r in recs] == list(range(recs[0].call, recs[0].call + tracing.KEEP))


@pytest.mark.parametrize("done, expected", [
    ([True, True], True), ([True, False], False), ([False, False], False), ([], True)])
def test_stop_check_returns_what_all_returns(done, expected):
    tensor = torch.tensor(done, dtype=torch.bool)
    assert tracing.stop_check(tensor) is bool(tensor.all()) is expected
    tracing.entry("e")(tracing.stop_check)(tensor)
    (rec,) = tracing.records()
    assert rec.counts["stop_checks"] == 1 and rec.spans["decode.stop_check"] >= 0


STEP_FNS = {"fused": (fused_greedy, "fused_greedy_step_ref"),
            "auto": (fast_step, "fast_decode_step"), "beam": (beam, "step_logp")}


@pytest.fixture
def ran(monkeypatch):
    """{kernel: the steps its decode ran}, counted at its step function."""
    calls = dict.fromkeys(STEP_FNS, 0)
    for kernel, (module, name) in STEP_FNS.items():
        def counted(*args, _fn=getattr(module, name), _kernel=kernel, **kwargs):
            calls[_kernel] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(module, name, counted)
    return calls


def decode(tiny, kernel, early):
    vocab, model, fast, tables, images = tiny
    if kernel == "beam":
        return beam_decode_images(model, fast, images, STEPS, beam_width=2,
                                  eos_id=vocab.eos_id, early_stop=early,
                                  stop_override=torch.tensor(STOPS) if early else None,
                                  plain=True)
    return decode_images(model, fast, images, tables, STEPS, kernel=kernel, plain=True,
                         early_stop_eos=vocab.eos_id if early else None,
                         stop_override=torch.tensor(STOPS) if early else None)


@pytest.mark.parametrize("kernel", ["fused", "auto", "beam"])
def test_a_decode_counts_its_steps_and_syncs(tiny, kernel, ran):
    decode(tiny, kernel, early=False)
    (rec,) = tracing.records()
    assert ran[kernel] == STEPS and rec.counts == {"steps": STEPS, "stop_checks": 0}
    tracing.reset()

    tokens = decode(tiny, kernel, early=True)
    (rec,) = tracing.records()
    expected = ran[kernel] - STEPS
    assert 0 < expected <= max(STOPS) + 1
    assert rec.counts == {"steps": expected, "stop_checks": expected}
    assert rec.entry == ("beam_decode_images" if kernel == "beam" else "decode_images")
    assert not rec.profiled
    assert {"encode", "encode.standardize", "encode.backbone", "encode.layers", "decode",
            "decode.prepare", "decode.stop_check"} <= set(rec.spans)
    assert "decode.step" not in rec.spans  # made only while a profiler records
    assert rec.spans["encode"] >= rec.spans["encode.backbone"] + rec.spans["encode.layers"]
    assert rec.spans["decode"] >= rec.spans["decode.prepare"] + rec.spans["decode.stop_check"]

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        profiled = decode(tiny, kernel, early=True)
    rec = tracing.records()[-1]
    assert rec.profiled and rec.counts == {"steps": expected, "stop_checks": expected}
    assert torch.equal(profiled, tokens)


def test_no_record_function_without_a_profiler(tiny, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    for kernel in ("fused", "auto", "beam"):
        decode(tiny, kernel, early=True)
    assert len(tracing.records()) == 3


def test_profile_trace_holds_the_programs_spans(tiny, tmp_path):
    with system.profile_trace(str(tmp_path / "trace")):
        decode(tiny, "fused", early=True)
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events if e.get("cat") == "user_annotation"}
    assert {"encode", "encode.standardize", "encode.backbone", "encode.layers", "decode",
            "decode.prepare", "decode.step", "decode.stop_check"} <= names
    steps = [e for e in events if e.get("name") == "decode.step"]
    assert len(steps) == tracing.records()[-1].counts["steps"]


def intervals(events, name):
    return sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("cat") == "user_annotation" and e.get("name") == name)


def inside(spans, t):
    return any(a <= t <= b for a, b in spans)


@pytest.mark.cuda
def test_spans_hold_the_kernels_on_the_card(tmp_path):
    """On the card, in the profiler's trace: every launch of the fused step
    (kernel 6) lies inside a ``decode.step`` and every host sync of the
    decode inside a ``decode.stop_check``, one per step run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the spans are held against the kernels' launches)")
    torch.manual_seed(0)
    card = torch.device("cuda")
    vocab = Vocab.from_files([TOKENS_PATH])
    with card:
        model = get_network(CONFIG["network"], CONFIG, vocab, dtype=torch.float32,
                            device=card).eval()
    fast, tables = build_fast(model), RuleTables.build(vocab, card)
    images = torch.randint(0, 256, (len(STOPS), 32, 64, 3),
                           generator=torch.Generator().manual_seed(1), dtype=torch.uint8)

    def run():
        return decode_images(model, fast, images.to(card), tables, STEPS, kernel="fused",
                             early_stop_eos=vocab.eos_id,
                             stop_override=torch.tensor(STOPS, device=card))

    run()  # builds and loads the kernels
    torch.cuda.synchronize()
    with system.profile_trace(str(tmp_path / "trace")):
        run()
        torch.cuda.synchronize()
    rec = tracing.records()[-1]
    with open(tmp_path / "trace" / "trace.json") as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    runtime = {e["args"]["correlation"]: e for e in events
               if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    launches = [runtime[e["args"]["correlation"]]["ts"] for e in events
                if e.get("cat") == "kernel" and "fused_greedy" in e.get("name", "")]
    steps, checks, decode_ = (intervals(events, n)
                              for n in ("decode.step", "decode.stop_check", "decode"))
    assert rec.profiled and len(launches) == rec.counts["steps"] > 0
    assert all(inside(steps, t) for t in launches)
    syncs = [e["ts"] for e in events if e.get("cat") == "cuda_runtime"
             and "Synchronize" in e.get("name", "") and inside(decode_, e["ts"])]
    assert len(syncs) == rec.counts["stop_checks"] == rec.counts["steps"]
    assert all(inside(checks, t) for t in syncs)
