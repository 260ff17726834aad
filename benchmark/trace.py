"""The device trace of a steady sub-window, read back from the profiler.

``profiler()`` records CPU and CUDA activity (CUPTI). ``Trace.load`` exports
the Chrome trace to a temporary file, reads it and deletes it. From it:

- kernels, each with its device interval and the host time of the launch
  call that issued it (the runtime event of the same correlation id);
- the benchmark's own annotations (``torch.profiler.record_function``),
  host intervals named "batch", "feed", "entry", "encode" and "fetch";
- which kernels a span issued: those whose launch call lies inside an
  annotation of that name (and outside an excluded one);
- busy time: the union of kernel intervals inside the window; copies and
  sets are not kernels and count as idle;
- idle gaps, split by the innermost annotation the host was in over each
  part of them.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

SPANS = ("feed", "encode", "entry", "fetch", "batch")  # innermost first


def profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


class Intervals:
    """Sorted, disjoint host intervals of one annotation name."""

    def __init__(self, spans: List[Tuple[float, float]]):
        self.spans = sorted(spans)
        self.starts = [s for s, _ in self.spans]

    def contains(self, t: float) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.spans[i][1]


class Trace:
    def __init__(self, events: List[dict]):
        launch: Dict[int, float] = {}
        self.kernels: List[Tuple[str, float, float, Optional[float]]] = []
        spans: Dict[str, List[Tuple[float, float]]] = {name: [] for name in SPANS}
        pending = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = str(e.get("cat", "")).lower()
            ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
            corr = (e.get("args") or {}).get("correlation")
            if cat == "kernel":
                pending.append((e.get("name", "?"), ts, dur, corr))
            elif cat in ("cuda_runtime", "cuda_driver") and corr is not None:
                launch[corr] = ts
            elif cat == "user_annotation" and e.get("name") in spans:
                spans[e["name"]].append((ts, ts + dur))
        self.kernels = [(n, ts, dur, launch.get(c)) for n, ts, dur, c in pending]
        self.kernels.sort(key=lambda k: k[1])
        self.spans = {name: Intervals(v) for name, v in spans.items()}

    @classmethod
    def load(cls, prof) -> "Trace":
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        finally:
            os.remove(path)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    def window(self) -> Optional[Tuple[float, float]]:
        """(first batch's start, last batch's end), in trace microseconds."""
        spans = self.spans["batch"].spans
        return (spans[0][0], spans[-1][1]) if spans else None

    def unattributed(self) -> int:
        """Kernels whose launch call the trace did not record."""
        return sum(1 for k in self.kernels if k[3] is None)

    def issued_by(self, name: str, exclude: Optional[str] = None):
        """Kernels launched while the host was inside ``name`` (and not
        inside ``exclude``)."""
        inside, outside = self.spans[name], self.spans[exclude] if exclude else None
        return [k for k in self.kernels if k[3] is not None and inside.contains(k[3])
                and not (outside and outside.contains(k[3]))]

    def merged(self, start: float, end: float) -> List[Tuple[float, float]]:
        """The union of kernel intervals, clipped to [start, end]."""
        out: List[List[float]] = []
        for _, ts, dur, _ in self.kernels:
            a, b = max(ts, start), min(ts + dur, end)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_us(self, start: float, end: float) -> float:
        return sum(b - a for a, b in self.merged(start, end))

    def host_label(self, t: float) -> str:
        """What the host was doing at trace time ``t``: the innermost of the
        benchmark's spans (the entry outside its encode is "decode")."""
        for name in SPANS:
            if self.spans[name].contains(t):
                return {"entry": "decode", "batch": "between_spans"}.get(name, name)
        return "between_batches"

    def idle_gaps(self, start: float, end: float) -> Dict[str, float]:
        """Idle device time in [start, end], in seconds, split by what the
        host was doing over each part of each gap."""
        edges = sorted({t for iv in self.spans.values() for span in iv.spans for t in span
                        if start < t < end})
        gaps: Dict[str, float] = {}
        t = start
        for a, b in self.merged(start, end) + [(end, end)]:
            if a > t:
                lo = bisect.bisect_right(edges, t)
                hi = bisect.bisect_left(edges, a)
                cuts = [t] + edges[lo:hi] + [a]
                for x, y in zip(cuts, cuts[1:]):
                    label = self.host_label((x + y) / 2)
                    gaps[label] = gaps.get(label, 0.0) + (y - x) / 1e6
            t = max(t, b)
        return gaps

    def top_kernels(self, start: float, end: float, k: int = 10) -> List[list]:
        """The ``k`` kernels with the most device time in [start, end]:
        [[name, seconds], ...]."""
        total: Dict[str, float] = {}
        for name, ts, dur, _ in self.kernels:
            if start <= ts < end:
                total[name] = total.get(name, 0.0) + dur / 1e6
        return [[n[:160], s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:k]]


def device_seconds(kernels) -> float:
    return sum(k[2] for k in kernels) / 1e6

