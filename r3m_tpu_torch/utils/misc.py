"""Host helpers, the port of ``r3m_tpu/utils/misc.py``'s: the learning-rate schedule grammar
(the reference's ``schedule()``, utils.py:143-163), tail-batch padding, seeding
(utils.py:34-39) and the training loop's step predicates and timer (utils.py:78-116)."""

from __future__ import annotations

import random
import re
import time
from typing import Callable, Union

import numpy as np
import torch


def set_seed_everywhere(seed: int) -> int:
    """Seed Python's, numpy's and torch's global generators; returns `seed`."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return seed


class Until:
    """True while ``step < until`` (utils.py:78-88); always true for ``until=None``."""

    def __init__(self, until, action_repeat: int = 1):
        self._until = until
        self._action_repeat = action_repeat

    def __call__(self, step: int) -> bool:
        if self._until is None:
            return True
        return step < int(self._until) // self._action_repeat


class Every:
    """True every `every` steps (utils.py:90-101). ``every`` of 0 or None is off (the
    reference would divide by zero); a positive one below `action_repeat` means every
    step, not never."""

    def __init__(self, every, action_repeat: int = 1):
        self._every = every
        self._action_repeat = action_repeat

    def __call__(self, step: int) -> bool:
        if self._every is None or int(self._every) <= 0:
            return False
        every = max(1, int(self._every) // self._action_repeat)
        return step % every == 0


class Timer:
    """Wall-clock timer: `reset` returns (seconds since the last reset, since creation)."""

    def __init__(self):
        self._start_time = time.time()
        self._last_time = time.time()

    def reset(self):
        elapsed = time.time() - self._last_time
        self._last_time = time.time()
        total = time.time() - self._start_time
        return elapsed, total

    def total_time(self) -> float:
        return time.time() - self._start_time


def schedule_fn(schdl: Union[str, float]) -> Callable[[int], float]:
    """Compile a schedule into a step -> value function.

    A float constant, ``'linear(init,final,duration)'`` or
    ``'step_linear(init,final1,duration1,final2,duration2)'``; the string is parsed once.
    """
    try:
        const = float(schdl)
        return lambda step: const
    except ValueError:
        pass
    match = re.match(r"linear\((.+),(.+),(.+)\)", schdl)
    if match:
        init, final, duration = (float(g) for g in match.groups())

        def linear(step):
            mix = min(max(step / duration, 0.0), 1.0)
            return (1.0 - mix) * init + mix * final

        return linear
    match = re.match(r"step_linear\((.+),(.+),(.+),(.+),(.+)\)", schdl)
    if match:
        init, final1, duration1, final2, duration2 = (float(g) for g in match.groups())

        def step_linear(step):
            if step <= duration1:
                mix = min(max(step / duration1, 0.0), 1.0)
                return (1.0 - mix) * init + mix * final1
            mix = min(max((step - duration1) / duration2, 0.0), 1.0)
            return (1.0 - mix) * final1 + mix * final2

        return step_linear
    raise NotImplementedError(schdl)


def pad_batch(arr: np.ndarray, n: int) -> np.ndarray:
    """Pad axis 0 to length `n` by repeating the last element.

    A tail batch padded to the fixed chunk size keeps one input shape for the whole job;
    callers slice the padded rows off the output (the embed CLI).
    """
    m = arr.shape[0]
    if m >= n:
        return arr
    return np.concatenate([arr, np.repeat(arr[-1:], n - m, axis=0)])
