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

The margin screens seeds; it does not prove one. It measures the port's own rounding, and
the JAX package's f32 step rounds its ReLU inputs 1.7 to 8.9 times more (the largest
|f32 - f64| of each ReLU call of ``tests/test_torch_parallel.py``'s step, seed 384). At
that seed the margin is 0.613, yet the JAX mesh step on one or two devices puts one input
of layer1.1's first ReLU (frame 4, channel 0, row 5, column 6 of the first microbatch) at
+4.8e-6, where the f64 forward has -8.4e-6 and the port's f32 -7.5e-6: JAX passes that
gradient and the port blocks it, and the leaves upstream of it part by up to 1.4e-3. So
where a test holds the port to a JAX step, `assert_relu_margin` also takes that step's own
ReLU inputs (`jax_relus` records them) and fails on any that falls on the other side of 0
from the f64 forward (`relu_flips`). A margin over both packages' roundings does not tell
such seeds apart: seed 225, whose comparison passes, keeps 0.067 of JAX's rounding and 384
0.125. A seed is kept only where the screen passes and its comparison passes.
"""

import contextlib
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


def relu_flips(forward, reference) -> list:
    """Where another computation's f32 ReLU inputs (`reference`: one array a ReLU call, in
    the port's call order and layout, as `jax_relus` records them) lie on the other side of
    0 from `forward`'s in float64: ``(call, index, f64 value, reference value)``, one a
    flipped input."""
    with relu_inputs() as seen:
        forward(torch.float64)
    if len(seen.inputs) != len(reference):
        raise ValueError(f"ReLU calls: {len(reference)} in the reference, "
                         f"{len(seen.inputs)} in f64")
    flips = []
    for call, (x64, ref) in enumerate(zip(seen.inputs, reference)):
        x64 = x64.numpy()
        ref = np.asarray(ref).reshape(x64.shape)
        for idx in np.argwhere((x64 > 0) != (ref > 0)):
            flips.append((call, tuple(int(i) for i in idx), float(x64[tuple(idx)]),
                          float(ref[tuple(idx)])))
    return flips


def assert_relu_margin(forward, seed, scale: float = RELU_ROUNDING, reference=None) -> None:
    """Fail, saying why, if the batch of `seed` puts a ReLU input within rounding of 0, or,
    given the JAX step's own ReLU inputs (`reference`), if that step flips one."""
    margin = relu_margin(forward)
    assert margin > scale, (
        f"seed {seed} now has a ReLU input within rounding of 0 (margin {margin:.3g} "
        f"roundings, against {scale:g}); pick another seed and say why")
    flips = [] if reference is None else relu_flips(forward, reference)
    assert not flips, (
        f"seed {seed}: the JAX step puts {len(flips)} ReLU input(s) on the other side of 0 "
        f"from the f64 forward (call, index, f64, JAX: {flips[:3]}), so its gradients part "
        "from the port's; pick another seed and say why")


_RECORDING = []  # the lists of the open `jax_relus` blocks, innermost last


def _keep_relu_input(x):
    if _RECORDING:
        x = np.array(x)
        _RECORDING[-1].append(x.transpose(0, 3, 1, 2) if x.ndim == 4 else x)


@contextlib.contextmanager
def jax_relus():
    """Inside ``with jax_relus() as seen:``, each ReLU input of a JAX program that runs is
    appended to ``seen`` in call order, 4-D ones from JAX's NHWC to the port's NCHW: a
    program traced in such a block calls `jax.nn.relu` through a host callback, and runs
    of it in a later block record there. The callbacks make such a program round like the
    JAX step, but not bit for bit as it."""
    import jax

    real = jax.nn.relu

    def relu(x):
        jax.debug.callback(_keep_relu_input, x, ordered=True)
        return real(x)

    seen = []
    _RECORDING.append(seen)
    jax.nn.relu = relu
    try:
        yield seen
        jax.effects_barrier()
    finally:
        jax.nn.relu = real
        _RECORDING.pop()


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


def test_flips_find_a_reference_input_on_the_other_side_of_zero():
    """The f32 inputs of the same layers agree in sign with the f64 ones; the same inputs
    with one element moved across 0 give that one flip, and the assertion names it."""
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(64, 16)))
    forward = lambda dtype: _layers(dtype, x)  # noqa: E731
    with relu_inputs() as seen:
        forward(torch.float32)
    reference = [t.numpy() for t in seen.inputs]
    assert relu_flips(forward, reference) == []
    assert_relu_margin(forward, 1, reference=reference)
    i = np.argwhere(reference[1] > 0)[0]
    reference[1][tuple(i)] *= -1
    flips = relu_flips(forward, reference)
    assert [(c, idx) for c, idx, _, _ in flips] == [(1, tuple(int(k) for k in i))]
    assert flips[0][2] > 0 > flips[0][3]
    with pytest.raises(AssertionError, match="seed 5: the JAX step puts 1 ReLU input"):
        assert_relu_margin(forward, 5, reference=reference)
    with pytest.raises(ValueError, match="ReLU calls"):
        relu_flips(forward, reference[:1])


def test_margin_needs_the_same_relus_in_both_precisions():
    with pytest.raises(ValueError, match="ReLU calls"):
        relu_margin(lambda dtype: F.relu(torch.ones(3, dtype=dtype))
                    if dtype == torch.float32 else None)
