"""Host helpers, the port of ``r3m_tpu/utils/misc.py``'s: the learning-rate schedule grammar
(the reference's ``schedule()``, utils.py:143-163) and tail-batch padding."""

from __future__ import annotations

import re
from typing import Callable, Union

import numpy as np


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
