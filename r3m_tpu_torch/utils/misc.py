"""Host helpers, the port of ``r3m_tpu/utils/misc.py``'s: the learning-rate schedule grammar
(the reference's ``schedule()``, utils.py:143-163), tail-batch padding, seeding
(utils.py:34-39), the training loop's step predicates and timer (utils.py:78-116), and the
rest of the reference's ``utils.py``: `eval_mode` (:18-31), `soft_update_params` (:42-45),
`orthogonal_init` (:52-61), `accuracy` (:63-76) and `truncated_normal` (:119-140)."""

from __future__ import annotations

import random
import re
import time
from typing import Callable, List, Sequence, Union

import numpy as np
import torch
from torch import nn


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


class eval_mode:
    """Context manager: each module given is in eval mode inside, and every submodule gets
    its own training flag back on exit (utils.py:18-31). Objects that are not modules pass
    through untouched."""

    def __init__(self, *models):
        self.models = models

    def __enter__(self):
        modules = [model for model in self.models if isinstance(model, nn.Module)]
        self._flags = [(m, m.training) for model in modules for m in model.modules()]
        for model in modules:
            model.train(False)
        return self

    def __exit__(self, *args):
        for m, training in self._flags:
            m.training = training
        return False


def soft_update_params(net_params, target_params, tau: float):
    """The EMA update ``tau * p + (1 - tau) * t`` over matching nested dicts, lists and
    tuples of tensors (utils.py:42-45); returns a new tree and changes neither input."""
    if isinstance(net_params, dict):
        return {k: soft_update_params(v, target_params[k], tau) for k, v in net_params.items()}
    if isinstance(net_params, (list, tuple)):
        return type(net_params)(soft_update_params(p, t, tau)
                                for p, t in zip(net_params, target_params, strict=True))
    return tau * net_params + (1 - tau) * target_params


def orthogonal_init(shape, gain: float = 1.0, dtype=torch.float32,
                    generator: torch.Generator = None) -> torch.Tensor:
    """An orthogonal weight of `shape` (utils.py:52-61 applies ``nn.init.orthogonal_``):
    ``shape[0]`` against the rest flattened, the output-channel axis of a torch weight, as
    the JAX package's last axis is of its layouts. Drawn in f32, returned in `dtype`."""
    w = torch.empty(tuple(shape), dtype=torch.float32)
    nn.init.orthogonal_(w, gain=gain, generator=generator)
    return w.to(dtype)


def accuracy(output: torch.Tensor, target: torch.Tensor,
             topk: Sequence[int] = (1,)) -> List[torch.Tensor]:
    """Top-k accuracy of logits ``[B, C]`` against labels ``[B]`` (utils.py:63-76), as
    fractions in [0, 1] (the reference's ``correct_k.mul_(1.0 / batch_size)``), not percent.
    The ranking is a stable sort of ``-output``, as ``jnp.argsort``'s, so tied logits rank
    the lower class first."""
    pred = torch.argsort(-output, dim=-1, stable=True)[:, :max(topk)]
    correct = pred == target[:, None]
    return [correct[:, :k].any(dim=-1).float().mean() for k in topk]


def truncated_normal(shape, mean: float = 0.0, std: float = 1.0, low: float = -2.0,
                     high: float = 2.0, generator: torch.Generator = None) -> torch.Tensor:
    """``mean + std * z`` in f32, z a standard normal truncated to [low, high]
    (utils.py:119-140)."""
    z = torch.empty(tuple(shape), dtype=torch.float32)
    nn.init.trunc_normal_(z, 0.0, 1.0, low, high, generator=generator)
    return mean + std * z


def schedule(schdl: Union[str, float], step: int) -> float:
    """The value of schedule `schdl` at `step` (utils.py:143-163), as a host float: the
    one grammar and parser of `schedule_fn`."""
    return float(schedule_fn(schdl)(step))


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
