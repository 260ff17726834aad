"""Host spans and counters of the port's inference entries: the program's
only span system.

Each call of an inference entry (``infer/single.py::decode_images`` and
``beam_decode_images``, the decode of ``infer/ensemble.py::run_ensemble``;
marked by ``entry``) opens one ``Record``: a call id that every span of the
call shares, whether a torch profiler was recording when the call started,
the host seconds of each span name, and the counts ``steps`` (decode steps
run) and ``stop_checks`` (early-stop host syncs). The last ``KEEP`` records
stay in memory (``records()``, ``reset()``); nothing is written to disk.

``span(name)`` adds its duration on the host clock to the current record.
Nested spans keep their whole duration; a reader derives self time. While
a torch profiler records, a span also enters
``torch.profiler.record_function(name)``, so that it lands in the Chrome
trace on the kernels' clock; otherwise no ``record_function`` is made, so
a span costs a clock pair and a dict add. Outside an entry a span records
nothing but still annotates a profile.

The spans (PERF.md §3 names the metric each serves): ``encode``, around
``encode_images``, with ``encode.standardize`` (kernel 1),
``encode.backbone`` (the CNN or Swin's patch embedding and stages) and
``encode.layers`` (SATRN's positional encoding and attention layers,
ASTER's BLSTM, Swin's final norm); ``decode``, around the decode loop's
call, with ``decode.prepare`` (cross K|V and buffers), ``decode.step``
(one step, its stop check nested in it, made only while a profiler
records: ``steps``) and ``decode.stop_check`` (``stop_check``).

Kernel launches are counted by ``ops/_build.py::LAUNCHES``, not here.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import itertools
import threading
import time
from typing import Deque, Dict, List, Optional

import torch

KEEP = 8192  # records kept: more calls than one benchmark run makes

_records: Deque["Record"] = collections.deque(maxlen=KEEP)
_ids = itertools.count()
_local = threading.local()  # the record open on this thread
_clock = time.perf_counter_ns
_profiling = torch._C._autograd._profiler_enabled


@dataclasses.dataclass
class Record:
    """One call of an inference entry."""

    call: int
    entry: str
    profiled: bool
    spans: Dict[str, float] = dataclasses.field(default_factory=dict)  # host seconds
    counts: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"steps": 0, "stop_checks": 0})

    def add(self, name: str, ns: int) -> None:
        self.spans[name] = self.spans.get(name, 0.0) + ns * 1e-9


def records() -> List[Record]:
    """The kept records, oldest first."""
    return list(_records)


def reset() -> None:
    _records.clear()


def current() -> Optional[Record]:
    """The record of the entry call running on this thread, if any."""
    return getattr(_local, "record", None)


def entry(name: str):
    """Decorator: each call of the function opens a record named ``name``;
    a call made inside another entry's call adds to that call's record."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if current() is not None:
                return fn(*args, **kwargs)
            rec = Record(next(_ids), name, _profiling())
            _records.append(rec)
            _local.record = rec
            try:
                return fn(*args, **kwargs)
            finally:
                _local.record = None

        return call

    return wrap


def _annotate(name: str):
    """An entered ``record_function(name)`` while a profiler records, else
    None."""
    if not _profiling():
        return None
    annotation = torch.profiler.record_function(name)
    annotation.__enter__()
    return annotation


class span:
    """``with span(name):`` times the block into the current record (and,
    while a profiler records, annotates it)."""

    __slots__ = ("name", "t0", "annotation")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.annotation = _annotate(self.name)
        self.t0 = _clock()
        return self

    def __exit__(self, *exc):
        ns = _clock() - self.t0
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        rec = current()
        if rec is not None:
            rec.add(self.name, ns)


def steps(n: int):
    """A decode loop's step indices: ``range(n)``, so a step costs nothing
    here; while a profiler records, each step (its body from one index to
    the next, or to the loop's end) is the span ``decode.step``."""
    return _annotated_steps(n) if _profiling() else range(n)


def _annotated_steps(n: int):
    for t in range(n):
        with span("decode.step"):
            yield t


def stop_check(done: torch.Tensor) -> bool:
    """``bool(done.all())``, the early-stop loop's host sync: counted in
    ``stop_checks``, and the host time blocked in it added to
    ``decode.stop_check``. After the sync, while the card waits for the
    next step, it does only a clock read and two adds."""
    rec, annotation = current(), _annotate("decode.stop_check")
    t0 = _clock()
    stop = bool(done.all())
    ns = _clock() - t0
    if annotation is not None:
        annotation.__exit__(None, None, None)
    if rec is not None:
        rec.add("decode.stop_check", ns)
        rec.counts["stop_checks"] += 1
    return stop


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the current record's count ``name``."""
    rec = current()
    if rec is not None:
        rec.counts[name] = rec.counts.get(name, 0) + n
