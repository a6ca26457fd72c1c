"""LR multiplier schedules (port of ``ccedit_tpu/train/lr_schedule.py``, the
reference's sgm/lr_scheduler.py): step -> multiplier of the base LR, for
``torch.optim.lr_scheduler.LambdaLR``."""

from __future__ import annotations

import math
from typing import Sequence


class LambdaWarmUpCosineScheduler:
    """Linear warm-up, then cosine from lr_max to lr_min over max_decay_steps."""

    def __init__(self, warm_up_steps, lr_min, lr_max, lr_start, max_decay_steps,
                 verbosity_interval=0):
        self.lr_warm_up_steps = warm_up_steps
        self.lr_start = lr_start
        self.lr_min = lr_min
        self.lr_max = lr_max
        self.lr_max_decay_steps = max_decay_steps

    def __call__(self, n: int) -> float:
        if n < self.lr_warm_up_steps:
            return (self.lr_max - self.lr_start) / self.lr_warm_up_steps * n + self.lr_start
        t = (n - self.lr_warm_up_steps) / (self.lr_max_decay_steps - self.lr_warm_up_steps)
        t = min(t, 1.0)
        return self.lr_min + 0.5 * (self.lr_max - self.lr_min) * (1 + math.cos(t * math.pi))


class _CycledScheduler:
    def __init__(self, warm_up_steps: Sequence[int], f_min, f_max, f_start, cycle_lengths,
                 verbosity_interval=0):
        if not len(warm_up_steps) == len(f_min) == len(f_max) == len(f_start) == len(cycle_lengths):
            raise ValueError("cycled scheduler lists differ in length")
        self.lr_warm_up_steps = list(warm_up_steps)
        self.f_start = list(f_start)
        self.f_min = list(f_min)
        self.f_max = list(f_max)
        self.cycle_lengths = list(cycle_lengths)
        self.cum_cycles = [0]
        for length in self.cycle_lengths:
            self.cum_cycles.append(self.cum_cycles[-1] + length)

    def find_in_interval(self, n: int) -> int:
        for i, cl in enumerate(self.cum_cycles[1:]):
            if n <= cl:
                return i
        return len(self.cycle_lengths) - 1

    def _warm_up(self, cycle: int, n: int) -> float:
        return ((self.f_max[cycle] - self.f_start[cycle]) / self.lr_warm_up_steps[cycle] * n
                + self.f_start[cycle])


class LambdaWarmUpCosineScheduler2(_CycledScheduler):
    """Cosine with several cycles."""

    def __call__(self, n: int) -> float:
        cycle = self.find_in_interval(n)
        n = n - self.cum_cycles[cycle]
        if n < self.lr_warm_up_steps[cycle]:
            return self._warm_up(cycle, n)
        t = (n - self.lr_warm_up_steps[cycle]) / (
            self.cycle_lengths[cycle] - self.lr_warm_up_steps[cycle])
        t = min(t, 1.0)
        return self.f_min[cycle] + 0.5 * (self.f_max[cycle] - self.f_min[cycle]) * (
            1 + math.cos(t * math.pi))


class LambdaLinearScheduler(_CycledScheduler):
    """Warm-up, then linear interpolation to f_min over the cycle (the
    schedule CCEdit's training configs use)."""

    def __call__(self, n: int) -> float:
        cycle = self.find_in_interval(n)
        n = n - self.cum_cycles[cycle]
        if n < self.lr_warm_up_steps[cycle]:
            return self._warm_up(cycle, n)
        return self.f_min[cycle] + (self.f_max[cycle] - self.f_min[cycle]) * (
            self.cycle_lengths[cycle] - n) / self.cycle_lengths[cycle]


SCHEDULERS = {cls.__name__: cls for cls in (
    LambdaWarmUpCosineScheduler, LambdaWarmUpCosineScheduler2, LambdaLinearScheduler)}
