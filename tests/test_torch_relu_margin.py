"""How far a batch keeps every ReLU input from 0, for the gradient-parity tests.

A ReLU whose input lands within rounding of 0 passes the gradient under one summation
order and blocks it under another, and moves every gradient leaf upstream of it by 1e-3 to
8e-3: the port against the JAX package, the card against the CPU, or W ranks against one.
The parity tests therefore run on batch seeds without such an input. `relu_margin` runs a
test's forward in f32 and again in f64 and sees every ReLU the port computes (``F.relu``,
``torch.relu``, ``relu_`` and ``nn.ReLU``, which calls ``F.relu``); `assert_relu_margin`
holds the test's seed to its premise before its gradients are compared, so that a change
that moves activations onto a rounding edge fails with a message that says so, not as a
gradient mismatch.

The margin of one ReLU call is its smallest |input| in f32 over the rounding of that
layer: the largest |f32 - f64| of its inputs, which carries the rounding of every layer
below it. A batch's margin is the smallest over every call; it must stay above
`RELU_ROUNDING`, a quarter of that rounding. The scale is measured, not derived: of the
ResNet-18 step of ``tests/test_torch_train_step.py`` on the batches of seeds 0-9, the
three whose port and JAX gradients part by more than 1e-3 (seeds 0, 8, 9: 6.6e-3, 1.8e-2,
1.2e-2) have margins 0.143, 0.136 and 0.005; seed 3, which that file uses, 0.472; two
seeds without a flip fall below it as well (4: 0.153, 7: 0.075), which costs a seed, not
a false pass. A scale relative to the layer's largest input (1e-5 or 1e-6 of it) does not
tell them apart: at these sizes the stem's smallest input is ~1e-7 of its largest on
every seed, far from any flip, while seed 0's flip three blocks down sits at 3e-7.

The margin screens seeds; it does not prove one. It measures the port's own rounding,
and the JAX package's BatchNorm variance (E[x^2] - E[x]^2) rounds more: one batch of
``tests/test_torch_parallel.py`` with a margin of 0.613 still parts from the JAX mesh
step in one configuration. A seed is kept only where its margin clears the scale and its
comparison passes.
"""

import copy
import dataclasses
from collections.abc import Mapping

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from r3m_tpu_torch.models.r3m import R3MConfig

RELU_ROUNDING = 0.25

_RELUS = {F.relu, F.relu_, torch.relu, torch.relu_, torch.Tensor.relu, torch.Tensor.relu_}


class relu_inputs(TorchFunctionMode):
    """Inside ``with relu_inputs() as seen:`` a copy of every ReLU call's input is kept in
    ``seen.inputs``, in call order."""

    def __init__(self):
        super().__init__()
        self.inputs = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in _RELUS:
            self.inputs.append(args[0].detach().clone())
        return func(*args, **(kwargs or {}))


def relu_margin(forward) -> float:
    """`forward(dtype)` runs the forward under test on a model and inputs in `dtype`. The
    smallest, over every ReLU call, of its smallest |input| in float32 over its largest
    |float32 - float64| (inf where the two agree exactly)."""
    runs = {}
    for dtype in (torch.float32, torch.float64):
        with relu_inputs() as seen:
            forward(dtype)
        runs[dtype] = seen.inputs
    lo, hi = runs[torch.float32], runs[torch.float64]
    if not lo or len(lo) != len(hi):
        raise ValueError(f"ReLU calls: {len(lo)} in f32, {len(hi)} in f64")
    margin = float("inf")
    for x, ref in zip(lo, hi):
        err = (x.double() - ref.double()).abs().max().item()
        if err:
            margin = min(margin, x.abs().min().item() / err)
    return margin


def assert_relu_margin(forward, seed, scale: float = RELU_ROUNDING) -> None:
    """Fail, saying why, if the batch of `seed` puts a ReLU input within rounding of 0."""
    margin = relu_margin(forward)
    assert margin > scale, (
        f"seed {seed} now has a ReLU input within rounding of 0 (margin {margin:.3g} "
        f"roundings, against {scale:g}); pick another seed and say why")


def step_forward(cfg, model, batch, perms, crops=None, bert=None, doaug="rctraj",
                 grad_accum=1):
    """`forward(dtype)` for `relu_margin`: what the port's train step computes before its
    backward on `batch` (with these permutations and crop rectangles, as a test hands them
    to ``make_train_step``'s step): the augmentation, then a microbatch at a time the
    encoder in train mode and the loss with its reward head, on a copy of `model`. In f64
    the config's compute dtype and the reward head's input are f64 too; the frozen
    DistilBERT's sentence embeddings are the f32 ones in both."""
    from r3m_tpu_torch.data.augment import random_resized_crop_clips
    from r3m_tpu_torch.training.trainer import _encode_and_loss, _language

    batch = {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}
    perms = [perms] if isinstance(perms, Mapping) else list(perms)
    with torch.no_grad():
        lang_emb, lang_mask = _language(cfg, bert, batch)
    prenorm = doaug in ("rc", "rctraj")

    def forward(dtype):
        run_cfg = _Float64Config(**dataclasses.asdict(cfg)) if dtype == torch.float64 else cfg
        m = copy.deepcopy(model).to(dtype)
        if m.lang_rew is not None:
            m.lang_rew.forward = _head_forward(m.lang_rew, dtype)
        images = batch["images"]
        if prenorm:
            mean, std = cfg.norm_stats
            images = random_resized_crop_clips(images, cfg.image_size, doaug,
                                               rects=torch.as_tensor(crops),
                                               compute_dtype=dtype, mean=mean, std=std)
        micro = images.shape[0] // grad_accum
        with torch.no_grad():
            for i in range(grad_accum):
                part = slice(i * micro, (i + 1) * micro)
                _encode_and_loss(run_cfg, m, images[part],
                                 None if lang_emb is None else lang_emb[part],
                                 None if lang_mask is None else lang_mask[part],
                                 perms[i], True, prenorm)

    return forward


def _head_forward(head, dtype):
    """The reward head's forward with its input in `dtype` (its own casts it to f32)."""
    return lambda e0, eg, le: head.pred(torch.cat([e0, eg, le], dim=-1).to(dtype)).squeeze(-1)


class _Float64Config(R3MConfig):
    """A config whose step computes in f64."""

    @property
    def torch_compute_dtype(self):
        return torch.float64


def _layers(dtype, x, moved=None):
    """Two linear layers with ReLUs on `x`, in `dtype`; `moved` replaces one first-layer
    pre-activation."""
    rng = np.random.default_rng(0)
    w1, w2 = (torch.from_numpy(rng.normal(size=s)).to(dtype) for s in ((16, 32), (32, 8)))
    h = x.to(dtype) @ w1
    if moved is not None:
        h[0, 0] = moved
    return F.relu(F.relu(h) @ w2)


def test_relu_inputs_sees_every_form_of_relu():
    x = torch.tensor([[-2.0, 0.5, 4.0]])
    with relu_inputs() as seen:
        F.relu(x)
        torch.relu(x)
        x.clone().relu_()
        torch.nn.ReLU()(x)
        torch.nn.ReLU(inplace=True)(x.clone())
        torch.tanh(x)
    assert len(seen.inputs) == 5 and all(torch.equal(i, x) for i in seen.inputs)


def test_margin_counts_roundings_and_flags_an_input_within_them():
    """A layer of normal inputs clears the scale by far; the same layer with one input
    put within a rounding step of 0 does not, and the assertion names the seed."""
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(64, 16)))
    assert relu_margin(lambda dtype: _layers(dtype, x)) > 10 * RELU_ROUNDING
    assert_relu_margin(lambda dtype: _layers(dtype, x), 1)
    edge = lambda dtype: _layers(dtype, x, moved=1e-7)  # noqa: E731
    assert relu_margin(edge) < RELU_ROUNDING
    with pytest.raises(AssertionError, match="seed 7 now has a ReLU input within rounding"):
        assert_relu_margin(edge, 7)


def test_margin_needs_the_same_relus_in_both_precisions():
    with pytest.raises(ValueError, match="ReLU calls"):
        relu_margin(lambda dtype: F.relu(torch.ones(3, dtype=dtype))
                    if dtype == torch.float32 else None)
