"""Learning-rate, momentum and teacher-forcing schedules as plain functions
of the step, port of ``p4fr_tpu/train/schedules.py``.

A schedule is ``step -> float``; the trainers read it at the number of
updates made so far and write the value into the optimizer before each
update (``train/steps.py``), so the first update uses ``schedule(0)`` as
the optax chain does.

- ``cosine_warmup_restarts``: CustomCosineAnnealingWarmUpRestarts in its
  per-iteration form: linear warmup base -> eta_max over T_up, cosine back
  to base over the rest of the cycle, cycle lengths
  T_{i+1} = (T_i - T_up) * T_mult + T_up, amplitude eta_max * gamma^cycle.
- ``constant_with_warmup``: transformers' constant schedule with warmup
  (the dual-optimizer trainer's decoder).
- ``circular_lr`` / ``circular_momentum``: CircularLRBeta's triangular LR
  and its Adam beta1 counter-cycle (momentum 0.95 -> 0.85).
- ``teacher_forcing_arctan`` / ``TeacherForcingScheduler``: the arctan
  decay of the teacher-forcing ratio, first 10% trimmed, tf_min after.
"""

from __future__ import annotations

import bisect
import math
from typing import Callable

import numpy as np

MAX_CYCLES = 64  # restart horizon precomputed (the trainers use one cycle)

Schedule = Callable[[int], float]


def cosine_warmup_restarts(eta_max: float, total_steps: int, *, base_lr: float = 0.0,
                           t_mult: int = 1, warmup_ratio: float = 0.1,
                           gamma: float = 0.8, cycles: int = 1) -> Schedule:
    """``cycles`` splits total_steps into T_0 = total_steps // cycles;
    ``warmup_ratio`` of each cycle is linear warmup."""
    t_0 = max(1, total_steps // max(1, cycles))
    t_up = int(t_0 * warmup_ratio)
    lengths = []
    t_i = t_0
    for _ in range(MAX_CYCLES):
        lengths.append(t_i)
        t_i = (t_i - t_up) * t_mult + t_up
    starts = np.concatenate([[0], np.cumsum(lengths)]).tolist()

    def schedule(step: int) -> float:
        cycle = min(bisect.bisect_right(starts[1:], step), MAX_CYCLES - 1)
        t_cur = step - starts[cycle]
        eta = eta_max * gamma ** cycle
        if t_cur < t_up:
            return (eta - base_lr) * t_cur / max(t_up, 1) + base_lr
        denom = max(lengths[cycle] - t_up, 1.0)
        return base_lr + (eta - base_lr) * (
            1 + math.cos(math.pi * (t_cur - t_up) / denom)) / 2

    return schedule


def constant_with_warmup(lr: float, warmup_steps: int) -> Schedule:
    def schedule(step: int) -> float:
        if step < warmup_steps:
            return lr * step / max(1.0, float(warmup_steps))
        return lr

    return schedule


def _cycle_step(step_size: int, cut_point: int) -> int:
    return int(step_size * (1 - cut_point / 100) / 2)


def circular_lr(lr_max: float, step_size: int, *, lr_divider: float = 10.0,
                cut_point: int = 10) -> Schedule:
    """Rises lr_max/div -> lr_max over cycle_step iterations, falls back over
    the next cycle_step, then decays toward ~0 over the tail; wraps every
    ``step_size`` iterations."""
    cycle_step = _cycle_step(step_size, cut_point)

    def schedule(step: int) -> float:
        it = step % step_size
        if it > 2 * cycle_step:
            cut = (it - 2 * cycle_step) / max(step_size - 2 * cycle_step, 1)
            return lr_max * (1 + cut * (1 - 100) / 100) / lr_divider
        if it > cycle_step:
            cut = 1 - (it - cycle_step) / max(cycle_step, 1)
        else:
            cut = it / max(cycle_step, 1)
        return lr_max * (1 + cut * (lr_divider - 1)) / lr_divider

    return schedule


def circular_momentum(step_size: int, *, m0: float = 0.95, m1: float = 0.85,
                      cut_point: int = 10) -> Schedule:
    """Beta1 falls m0 -> m1 while ``circular_lr`` rises, climbs back while it
    falls, and stays at m0 through the tail."""
    cycle_step = _cycle_step(step_size, cut_point)

    def schedule(step: int) -> float:
        it = step % step_size
        if it > 2 * cycle_step:
            return m0
        if it > cycle_step:
            cut = 1 - (it - cycle_step) / max(cycle_step, 1)
        else:
            cut = it / max(cycle_step, 1)
        return m0 + cut * (m1 - m0)

    return schedule


def teacher_forcing_arctan(num_steps: int, tf_max: float, tf_min: float) -> np.ndarray:
    """Per-step teacher-forcing ratios (the 10% trim included); callers take
    tf_min past the end."""
    if num_steps < 2:  # degenerate runs: constant tf_max
        return np.full(max(num_steps, 1), tf_max, np.float64)
    diff = tf_max - tf_min
    inflection = int(num_steps * 0.1)
    x = np.linspace(-5, 5, num_steps)
    x = -np.arctan(x)
    x -= x[-1]
    x *= diff / x[0]
    x += tf_min
    return x[inflection:].astype(np.float64)


class TeacherForcingScheduler:
    """The reference's stateful ``step()`` over ``teacher_forcing_arctan``."""

    def __init__(self, num_steps: int, tf_max: float = 1.0, tf_min: float = 0.4):
        self.values = teacher_forcing_arctan(num_steps, tf_max, tf_min)
        self.tf_min = tf_min
        self.i = 0

    def step(self) -> float:
        if self.i < len(self.values):
            v = float(self.values[self.i])
            self.i += 1
            return v
        return float(self.tf_min)

    def state_dict(self):
        return {"i": self.i}

    def load_state_dict(self, d):
        self.i = int(d["i"])
