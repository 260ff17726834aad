"""One run of one benchmark cell: set-up, the measured window, the check.

The cell (``BENCHMARK.json``'s workload entry) names a configuration
(``configs/<name>.json``), a traffic mix (``traffic/<name>.json``, read by
the generator module it names) and its own file (``workloads/<name>.json``:
batch, pool, the check's sample and limits). Per-layer metrics are readers
found by name (``metrics/<name>.py``, the name up to its first dot).

The system under test is ``p4fr_tpu_torch``: its model from
``models/registry.get_network``, loaded with the benchmark's seeded weights,
``infer.single.build_fast`` and the manager's ``RuleTables``. One closed-loop
client runs, as ``infer/single.py::run_inference`` does: for each batch it
uploads the u8 images with a pageable copy, calls
``infer.single.decode_images`` (the fused greedy step) and copies the tokens
to the host. A batch's latency runs from the start of its upload to its
tokens on the host; the window runs from the first upload to the last
batch's tokens. Batches start until ``seconds`` have passed, and then until
the cycle of the pool in progress is complete, so that every run serves
whole cycles: the same work in every run and for every seed.

``setup_s`` runs from the process's start to the first timed batch, less
the seconds in which the benchmark makes its stand-in checkpoint (the
seeded draw and the reference's BatchNorm calibration, ``weights.served``):
the program's build, ``load_state_dict``, fast decoder and warm batch count.

With tracing on, the benchmark's own spans time each batch: the upload on
the host clock, and on the device (CUDA events) the encode, caught by
wrapping ``infer.single.encode_images`` for the run, and the rest of the
entry, the decode; these spans are read over the batches before the
profiler starts. The profiler records the window's last whole cycles, at
least ``TRACE_SECONDS`` of them: it starts at the first cycle's start once
``seconds - TRACE_SECONDS`` have passed, the window then runs on to a
cycle's end at least ``TRACE_SECONDS`` later, and the profiler stops (and
reads its events) after the window has closed.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import check, trace, weights
from benchmark.reference.manager import Rules
from benchmark.traffic import batches

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "p4fr_tpu")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
TRACE_SECONDS = 5.0  # the least length of the profiled sub-window
CHECKPOINT = ("draw", "calibrate")  # set-up parts that stand in for a checkpoint file


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


@dataclasses.dataclass
class Spec:
    name: str
    work: dict  # workloads/<name>.json
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json
    end_to_end: List[str]
    per_layer: List[str]
    units: Dict[str, str]


def load_spec(name: str, root: str = ROOT) -> Spec:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json`` and its files."""
    bench = load_json(root, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    here = os.path.join(root, "benchmark")
    work = load_json(here, "workloads", f"{name}.json")

    def reported(metric):
        return name in metric.get("workloads", [name])

    return Spec(name, work, load_json(here, "configs", f"{cell['config']}.json"),
                load_json(here, "traffic", f"{cell['traffic']}.json"),
                [m["name"] for m in bench["end_to_end"] if reported(m)],
                [m["name"] for m in bench["per_layer"] if reported(m)],
                {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]})


def sub_seed(seed: int, tag: int) -> int:
    return int(np.random.SeedSequence([seed % 2 ** 63, tag]).generate_state(1, np.uint64)[0])


def process_start() -> float:
    """The wall-clock time this process started (from /proc; else now)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_modules() -> List[str]:
    """Top-level modules of the JAX side loaded in this process, compared
    whole (``p4fr_tpu_torch`` is not ``p4fr_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Program:
    """The system under test on ``device``, loaded with ``state`` (the
    benchmark's weights in the served type)."""

    def __init__(self, spec: Spec, state: Dict[str, torch.Tensor], device):
        from p4fr_tpu_torch.data.vocab import TOKENS_PATH, Vocab
        from p4fr_tpu_torch.decoding.manager import RuleTables
        from p4fr_tpu_torch.infer import single
        from p4fr_tpu_torch.models.registry import get_network

        cfg = spec.config
        self.single, self.device = single, torch.device(device)
        self.vocab = Vocab.from_files([TOKENS_PATH])
        dtype = DTYPES[cfg["dtype"]]
        with torch.device(self.device):
            self.model = get_network(cfg["network"], cfg, self.vocab, dtype=dtype,
                                     device=self.device)
        self.model.load_state_dict(state, strict=True)
        self.fast = single.build_fast(self.model)
        self.tables = RuleTables.build(self.vocab, self.device)

    def serve(self, images: torch.Tensor, stops: Optional[torch.Tensor],
              steps: int) -> torch.Tensor:
        """``decode_images`` on a batch already on the card."""
        early = stops is not None
        return self.single.decode_images(
            self.model, self.fast, images, self.tables, steps, kernel="fused",
            early_stop_eos=self.vocab.eos_id if early else None, stop_override=stops)


def make_traffic(spec: Spec, seed: int):
    gen = importlib.import_module(f"benchmark.traffic.{spec.traffic['generator']}")
    return gen.generate(spec.traffic, batch=spec.work["batch"], pool=spec.work["pool"],
                        hw=input_hw(spec.config), channels=channels(spec.config),
                        seed=sub_seed(seed, 1))


def input_hw(config: dict):
    return config["input_size"]["height"], config["input_size"]["width"]


def channels(config: dict) -> int:
    return int(config.get("data", {}).get("rgb", 3))


def make_weights(spec: Spec, seed: int, vocab: int, device,
                 times: Optional[Dict[str, float]] = None) -> Dict[str, torch.Tensor]:
    """The seed's served weights (``weights.served``), their BatchNorm
    statistics taken over eight seeded images."""
    calibration = batches.images(np.random.default_rng(sub_seed(seed, 3)), 1, 8,
                                 input_hw(spec.config), channels(spec.config))[0]
    return weights.served(spec.config, vocab, sub_seed(seed, 0), DTYPES[spec.config["dtype"]],
                          device, torch.from_numpy(calibration).to(device), times)


def choose_sample(spec: Spec, traffic, seed: int):
    """{run batch index: rows} to compare: batches of the first cycle, the
    one holding the pool's longest request first, with that row."""
    rng = np.random.default_rng(sub_seed(seed, 2))
    chk, batch = spec.work["check"], spec.work["batch"]
    cycle = max(len(traffic.order), len(traffic.images))
    longest = int(traffic.lengths.max(1).argmax())
    first = next(i for i in range(cycle) if traffic.batch(i) == longest)
    rest = [i for i in range(cycle) if i != first]
    picks = [first] + list(rng.choice(rest, min(len(rest), chk["batches"] - 1), replace=False))
    out = {}
    for i in picks:
        rows = rng.choice(batch, min(batch, chk["rows"]), replace=False)
        top = int(traffic.lengths[longest].argmax())
        if i == first and top not in rows:
            rows[0] = top
        out[int(i)] = np.sort(rows)
    return out


class Catcher:
    """Wraps ``infer.single.encode_images`` for the run: keeps the memory
    of the sampled batches and, when tracing, brackets the encode with CUDA
    events and a host span."""

    def __init__(self, single, keep, tracing: bool):
        self.single, self.keep, self.tracing = single, keep, tracing
        self.kept: Dict[int, torch.Tensor] = {}
        self.index = -1
        self.events: List[tuple] = []
        self.orig = single.encode_images

    def __call__(self, model, images, *, plain=False):
        if not self.tracing:
            mem = self.orig(model, images, plain=plain)
        else:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            with torch.profiler.record_function("encode"):
                start.record()
                mem = self.orig(model, images, plain=plain)
                end.record()
            self.events.append((start, end))
        if self.index in self.keep:
            self.kept[self.index] = mem
        return mem

    def __enter__(self):
        self.single.encode_images = self
        return self

    def __exit__(self, *exc):
        self.single.encode_images = self.orig


def stops_on_device(traffic, device) -> List[Optional[torch.Tensor]]:
    if not traffic.early_stop:
        return [None] * len(traffic.lengths)
    return [torch.from_numpy(traffic.stops(b)).to(device) for b in range(len(traffic.lengths))]


def launches() -> Dict[str, int]:
    from p4fr_tpu_torch.ops import _build

    return dict(_build.LAUNCHES)


def window(program: Program, traffic, stops, seconds: float, catcher: Catcher,
           tracing: bool) -> dict:
    """The closed loop for ``seconds``, then to the end of the pool's cycle;
    with ``tracing``, spans and a profiled sub-window of whole cycles at the
    window's end."""
    dev = program.device
    out = {"lat": [], "batches": [], "served": [], "spans": [], "traced": [],
           "prof": None, "ends": []}
    cycle = len(traffic.order)
    prof, profiling, before = None, False, launches()
    t0 = time.perf_counter()
    t_end = p0 = t0
    i = 0
    while (time.perf_counter() < max(t0 + seconds, p0 + TRACE_SECONDS if profiling else t0)
           or i % cycle):
        start = time.perf_counter()
        b = traffic.batch(i)
        catcher.index = i
        images = traffic.images[traffic.image_set(i)]
        if not tracing:
            x = torch.from_numpy(images).to(dev)
            host = program.serve(x, stops[b], traffic.max_steps).cpu()
        else:
            if prof is None and i % cycle == 0 and start >= t0 + seconds - TRACE_SECONDS:
                prof = out["prof"] = trace.profiler()
                prof.__enter__()
                profiling = True
                start = p0 = time.perf_counter()
            n0 = launches().get("fused_greedy_step", 0)
            with torch.profiler.record_function("batch"):
                with torch.profiler.record_function("feed"):
                    x = torch.from_numpy(images).to(dev)
                fed = time.perf_counter()
                e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                with torch.profiler.record_function("entry"):
                    e0.record()
                    tokens = program.serve(x, stops[b], traffic.max_steps)
                    e1.record()
                with torch.profiler.record_function("fetch"):
                    host = tokens.cpu()
            steps = launches().get("fused_greedy_step", 0) - n0
            out["spans"].append({"feed_s": fed - start, "entry": (e0, e1), "steps": steps,
                                 "profiled": profiling})
            if profiling:
                out["traced"].append((b, steps))
        t_end = time.perf_counter()
        out["lat"].append(t_end - start)
        out["ends"].append(t_end - t0)
        out["batches"].append(b)
        out["served"].append(host)
        i += 1
    if profiling:
        prof.__exit__(None, None, None)
    after = launches()
    out["window_s"] = t_end - t0
    out["cycle"] = cycle
    out["launches"] = {k: v - before.get(k, 0) for k, v in after.items()
                       if v != before.get(k, 0)}
    return out


def halves(w: dict, batch: int) -> str:
    """Images/s over the window's first and second half, split at a cycle's
    end: how far a run drifts within its window, against how far runs
    differ."""
    cycles = len(w["lat"]) // w["cycle"]
    h = cycles // 2 * w["cycle"]
    if not h or h == len(w["lat"]):
        return f"window {w['window_s']:.3f} s over {len(w['lat'])} batches"
    mid = w["ends"][h - 1]
    return (f"window {w['window_s']:.3f} s over {len(w['lat'])} batches, "
            f"{cycles} cycles of {w['cycle']}; images/s by half: "
            f"{h * batch / mid:.3f}, {(len(w['lat']) - h) * batch / (w['window_s'] - mid):.3f}")


@dataclasses.dataclass
class Readings:
    """What the per-layer metric readers (``metrics/<name>.py``) read."""

    config: dict
    batch: int
    vocab: int
    max_steps: int
    traffic: object
    spans: List[dict]  # per batch before the profiler: feed_s, encode_ms, decode_ms, steps
    traced: List[tuple]  # (pool batch, steps) of the profiled batches
    trace: Optional[trace.Trace]
    _encoder_flops: Optional[int] = None

    @property
    def encoder_flops(self) -> int:
        """One image's encode, counted over the reference (``costs``)."""
        from benchmark import costs

        if self._encoder_flops is None:
            self._encoder_flops = costs.encoder_flops(self.config, self.vocab)
        return self._encoder_flops

    @property
    def trace_window(self):
        return None if self.trace is None else self.trace.window()


def base(name: str) -> str:
    """What a metric measures: its name up to the first dot. A suffix
    splits one quantity between cells that report different end-to-end
    metrics (``feed_ms.early_stop`` moves ``images_per_s.early_stop``)."""
    return name.split(".")[0]


def read_metric(name: str, readings: Readings):
    """The per-layer metric ``name``, read by ``metrics/<base(name)>.py``."""
    return importlib.import_module(f"benchmark.metrics.{base(name)}").read(readings)


@dataclasses.dataclass
class Cell:
    """A cell set up for one seed: the program, the weights it was given
    (on the host, for the reference), the traffic and the sample."""

    program: Program
    state: Dict[str, torch.Tensor]
    traffic: object
    stops: List[Optional[torch.Tensor]]
    sample: Dict[int, np.ndarray]
    rules: Rules


def setup(spec: Spec, seed: int, device, times: Optional[Dict[str, float]] = None) -> Cell:
    """The cell for ``seed``; ``times`` gets the seconds of each part."""
    times = {} if times is None else times
    t = time.perf_counter()
    torch.zeros(1, device=device)
    times["device"] = time.perf_counter() - t
    rules = Rules()
    state = make_weights(spec, seed, len(rules), device, times)
    t = time.perf_counter()
    program = Program(spec, state, device)
    if len(program.vocab) != len(rules):
        raise ValueError(f"the program's vocabulary has {len(program.vocab)} tokens, "
                         f"the benchmark's {len(rules)}")
    state = {k: v.cpu() for k, v in state.items()}
    times["program"] = time.perf_counter() - t
    t = time.perf_counter()
    traffic = make_traffic(spec, seed)
    times["traffic"] = time.perf_counter() - t
    return Cell(program, state, traffic, stops_on_device(traffic, program.device),
                choose_sample(spec, traffic, seed), rules)


def kept_rows(catcher: Catcher, sample) -> Dict[int, torch.Tensor]:
    """The sampled rows of the memories the catcher kept, in f32 on the host."""
    return {i: catcher.kept[i][torch.as_tensor(rows)].float().cpu()
            for i, rows in sample.items() if i in catcher.kept}


def judge(spec: Spec, cell: Cell, kept: Dict[int, torch.Tensor], served: List[np.ndarray],
          pool_batches: List[int], device, control: bool = False) -> Dict[str, float]:
    """The numbers ``correct`` compares (``check``), once the program is
    freed: the sample against the reference (and, with ``control``, the
    fp8 control's), every served batch exactly, and the sampled batches
    that never came back."""
    traffic, rules = cell.traffic, cell.rules
    rows = [(i, r) for i, r in cell.sample.items() if i < len(served)]
    out = {"missing_batches": len(cell.sample) - len(rows)}
    if rows:
        sample = check.Sample(
            np.concatenate([traffic.images[traffic.image_set(i)][r] for i, r in rows]),
            torch.cat([kept[i] for i, _ in rows]) if all(i in kept for i, _ in rows) else None,
            np.concatenate([served[i][r] for i, r in rows]),
            np.concatenate([traffic.stops(pool_batches[i])[r] for i, r in rows])
            if traffic.early_stop else None)
        vocab = len(rules)
        ref = check.reference(spec.config, cell.state, vocab, device)
        ctl = check.reference(spec.config, cell.state, vocab, device, control=True) if control else None
        out.update(check.compare(ref, sample, rules, device, ctl))
    else:
        out.update(memory_rel_err=float("inf"), logit_gap=float("inf"))
    out.update(check.exact(
        served, [traffic.stops(b) if traffic.early_stop else None for b in pool_batches],
        rules, (spec.work["batch"], traffic.max_steps)))
    return out


def run(spec: Spec, seed: int, seconds: float, tracing: bool, device="cuda",
        started: Optional[float] = None, log=None) -> dict:
    """One run of the cell: the result line's fields (without the device's
    name), and ``checks`` {name: (value, limit)}."""
    started = time.time() if started is None else started
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    cuda = torch.device(device).type == "cuda"
    times = {"start": time.time() - started}
    cell = setup(spec, seed, device, times)
    program, traffic, stops = cell.program, cell.traffic, cell.stops
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    with Catcher(program.single, set(cell.sample), tracing) as catcher:
        longest = int(traffic.lengths.max(1).argmax())
        warm = torch.from_numpy(traffic.images[0]).to(program.device)
        t = time.perf_counter()
        program.serve(warm, stops[longest], traffic.max_steps).cpu()  # the cell's shapes
        catcher.events.clear()
        times["warm"] = time.perf_counter() - t
        setup_s = time.time() - started - sum(times.get(k, 0.0) for k in CHECKPOINT)
        w = window(program, traffic, stops, seconds, catcher, tracing)
    if cuda:
        torch.cuda.synchronize()
    log("setup seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
        + f"; setup_s {setup_s:.3f}")
    peak = torch.cuda.max_memory_allocated(program.device) if cuda else 0
    n_batches, batch = len(w["lat"]), spec.work["batch"]
    log(f"launches over {n_batches} timed batches: {json.dumps(w['launches'])}; "
        f"fused_greedy_step a batch "
        f"{w['launches'].get('fused_greedy_step', 0) / max(n_batches, 1):.3f} "
        f"(steps a batch by the traffic "
        f"{np.mean([traffic.steps(b) for b in w['batches']]) if n_batches else 0:.3f})")
    log(halves(w, batch))
    spans = [{"feed_s": span["feed_s"], "encode_ms": e0.elapsed_time(e1),
              "decode_ms": e1.elapsed_time(span["entry"][1]), "steps": span["steps"]}
             for span, (e0, e1) in zip(w["spans"], catcher.events)
             if not span["profiled"]]  # the profiler slows the host's issue
    kept = kept_rows(catcher, cell.sample)
    served = [t.numpy() for t in w["served"]]
    tr = trace.Trace.load(w["prof"]) if w["prof"] is not None else None
    cell.program = program = catcher = warm = None
    w["served"] = None
    if cuda:
        torch.cuda.empty_cache()
    readings = judge(spec, cell, kept, served, w["batches"], device)
    limits = dict(spec.work["limits"], missing_batches=0)
    checks = {k: (readings[k], limits[k]) for k in limits}

    metrics = {}
    if not tracing:
        e2e = {"images_per_s": batch * n_batches / w["window_s"],
               "latency_p95_ms": float(np.percentile(w["lat"], 95)) * 1e3, "setup_s": setup_s}
        metrics = {k: (e2e[base(k)], spec.units[k]) for k in spec.end_to_end}
    device_info = {"memory_peak_bytes": int(peak)}
    breakdown = None
    if tracing:
        r = Readings(spec.config, batch, len(cell.rules), traffic.max_steps, traffic, spans,
                     w["traced"], tr)
        for name in spec.per_layer:
            value = read_metric(name, r)
            if value is not None:
                metrics[name] = (value, spec.units[name])
        win = r.trace_window
        if win is not None:
            device_info["busy_s"] = tr.busy_us(*win) / 1e6
            device_info["window_s"] = (win[1] - win[0]) / 1e6
            gaps = sorted(tr.idle_gaps(*win).items(), key=lambda kv: -kv[1])[:10]
            breakdown = {"device_ops": tr.top_kernels(*win),
                         "idle_gaps": [[k, v] for k, v in gaps]}
            if tr.unattributed():
                log(f"trace: {tr.unattributed()} kernels without their launch call")
    return {"correct": all(v <= lim for v, lim in checks.values()),
            "attempted": batch * n_batches, "failed": 0, "metrics": metrics,
            "device": device_info, "breakdown": breakdown, "checks": checks,
            "batches": n_batches}

