"""The port's data-parallel train and eval steps (`make_train_step(mesh=...)`, one process a
rank, gloo on the CPU) against the JAX package's mesh step on the suite's virtual CPU
devices, at world size 2 and 4, with and without ``grad_accum=2``.

ResNet-18 (hidden 64, 32 px crops of 40x48 frames, BatchNorm unpacked), a global batch of
8 clips, rctraj, language + TCN + L1/L2 losses, BERT_SMALL, the JAX state carried to the
port. The JAX mesh step draws its crops and permutations from ``state.key``; the test
derives them the same way and hands them to every rank. Rank ``r`` holds the rows
`local_rows(8, A, W, r)`, so that each gathered microbatch is the JAX step's.

The rows' brightness grows with their index, so the ranks' BatchNorm moments differ by a
wide margin: BatchNorm over each rank's own rows would move the loss and the statistics.
The gradients are compared themselves (the port's averaged ``.grad`` against the JAX
step's Adam first moment over 0.1), not only through the update: Adam's first update is
the gradient's sign, which W-times-too-large gradients would leave as it is.

Tolerances, f32: loss and metrics rtol 1e-4; every gradient leaf relative L2 1e-3 (a
leaf whose gradient is rounding noise against 1e-4 of the global norm); the parameters
after one Adam update at lr 1e-6 relative L2 1e-3 a leaf (the same floor: a zero-init
bias whose gradient is noise moves by +-lr either way); BatchNorm running statistics
rtol 1e-4 (atol 1e-6).
As ``tests/test_torch_train_step.py`` says, a ReLU input within rounding of 0 would move
the leaves upstream of it by ~3e-3; the batch seeds below have none at these shapes, one
for each ``grad_accum`` (each microbatch is a BatchNorm batch of its own), and the test
asserts that before it compares (``tests/test_torch_relu_margin.py``), against the port's
rounding and against the JAX step's own ReLU inputs.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import jax

from r3m_tpu.data import augment as jaugment
from r3m_tpu.losses import draw_permutations as jax_draw_permutations
from r3m_tpu.models.distilbert import DistilBertConfig as JaxBertConfig
from r3m_tpu.models.distilbert import distilbert_init
from r3m_tpu.models.r3m import R3MConfig as JaxR3MConfig
from r3m_tpu.parallel.mesh import make_mesh as jax_make_mesh
from r3m_tpu.parallel.mesh import replicate, shard_batch
from r3m_tpu.training import trainer as jtrainer
from r3m_tpu_torch.convert import distilbert_from_jax, model_from_jax, state_dict_from_jax
from r3m_tpu_torch.models.r3m import R3MConfig, r3m_init
from r3m_tpu_torch.parallel.mesh import launch_local, local_rows
from r3m_tpu_torch.training.trainer import make_eval_step, make_train_step
from tests.test_torch_parallel_worker import run_step
from tests.test_torch_relu_margin import (
    RELU_ROUNDING,
    assert_relu_margin,
    jax_relus,
    relu_flips,
    relu_margin,
    step_forward,
)

BERT_SMALL = dict(vocab_size=100, dim=768, n_layers=1, n_heads=4, hidden_dim=128,
                  max_position_embeddings=16)
CLIPS, FRAME_HW, TOKENS = 8, (40, 48), 12
RTOL = 1e-4
GRAD_REL_L2 = 1e-3
# The batch of each grad_accum. Seed 19, which served both before, keeps a margin of 0.256
# roundings at grad_accum 1 and 0.020 at 2, under the scale; of seeds 0-399 none keeps
# 0.25 at both. 382 keeps the widest at 1 (0.467). At 2, 384 keeps the widest (0.613) and
# still parts from the JAX mesh step at W=2 by 1.4e-3 in layer1's leaves (W=4: 2.6e-5):
# the JAX step on one or two devices flips one ReLU input that the port and f64 keep
# below 0 (`test_relu_screen_rejects_the_seed_whose_jax_step_flips_a_relu`); 225, the
# next (0.455), flips none and agrees.
BATCH_SEEDS = {1: 382, 2: 225}
FLIPPED_SEED = 384  # grad_accum 2
RANK_TIMEOUT = 240  # seconds a launch of ranks may take before it is stopped


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(rng):
    base = rng.integers(0, 96, (CLIPS, 5, *FRAME_HW, 3))
    images = base + 20 * np.arange(CLIPS)[:, None, None, None, None]  # brighter row by row
    mask = np.ones((CLIPS, TOKENS), np.int32)
    mask[1, 7:] = 0
    mask[6, 3:] = 0
    return {
        "images": np.clip(images, 0, 255).astype(np.uint8),
        "token_ids": rng.integers(0, 100, (CLIPS, TOKENS)).astype(np.int32),
        "attn_mask": mask,
        "lang_mask": np.array([1, 1, 0, 1, 1, 1, 1, 0], np.float32),
    }


def _draws(key, grad_accum, num_neg):
    """What the JAX step draws from `key`: rctraj rectangles and one permutation set per
    global microbatch."""
    perm_key, aug_key, _ = jax.random.split(key, 3)
    rects = np.stack([np.array(jaugment.sample_crop_params(k, *FRAME_HW))
                      for k in jax.random.split(aug_key, CLIPS)])
    keys = [perm_key] if grad_accum == 1 else list(jax.random.split(perm_key, grad_accum))
    perms = [{k: torch.from_numpy(np.array(v)).long()
              for k, v in jax_draw_permutations(pk, CLIPS // grad_accum, num_neg).items()}
             for pk in keys]
    return torch.from_numpy(rects), perms


class Setup:
    def __init__(self, tmp):
        kw = dict(size=18, hidden_dim=64, l2weight=1e-5, l1weight=1e-5, tcnweight=1.0,
                  langweight=1.0, image_size=32, packed_bn=False, lr=1e-6)
        self.cfg_kw = kw
        self.jcfg = JaxR3MConfig(**kw)
        self.bert_cfg = JaxBertConfig(**BERT_SMALL)
        self.jbert = distilbert_init(jax.random.PRNGKey(7), self.bert_cfg)
        self.jstate = jtrainer.create_train_state(self.jcfg, jax.random.PRNGKey(0))
        self.batches = {a: _batch(np.random.default_rng(seed)) for a, seed in BATCH_SEEDS.items()}
        self.batch = self.batches[1]
        self.tmp = tmp
        self.cache = {}

    def port_inputs(self, name, batch=None, **extra):
        s = self.jstate
        batch = self.batch if batch is None else batch
        path = os.path.join(self.tmp, f"{name}.pt")
        torch.save({
            "cfg": self.cfg_kw,
            "model": model_from_jax(R3MConfig(**self.cfg_kw), _np(s.params),
                                    _np(s.batch_stats)),
            "bert": distilbert_from_jax(_np(self.jbert), n_heads=BERT_SMALL["n_heads"]),
            "batch": {k: torch.from_numpy(v) for k, v in batch.items()},
            **extra,
        }, path)
        return path

    def jax_train(self, world, grad_accum):
        key = ("jax", world, grad_accum)
        if key not in self.cache:
            mesh = jax_make_mesh(world)
            step = jtrainer.make_train_step(self.jcfg, self.jbert, mesh=mesh, donate=False,
                                            doaug="rctraj", grad_accum=grad_accum,
                                            bert_cfg=self.bert_cfg)
            new, metrics = step(replicate(mesh, self.jstate),
                                shard_batch(mesh, self.batches[grad_accum]))
            self.cache[key] = (_np(new), {k: float(v) for k, v in metrics.items()})
        return self.cache[key]

    def port_train(self, world, grad_accum, variant="ok"):
        key = ("port", world, grad_accum, variant)
        if key not in self.cache:
            crops, perms = _draws(self.jstate.key, grad_accum, self.jcfg.num_negatives)
            name = f"train_w{world}_a{grad_accum}_{variant}"
            inputs = self.port_inputs(name, self.batches[grad_accum], crops=crops, perms=perms)
            out = os.path.join(self.tmp, name + "_rank%d.pt")
            launch_local(run_step, world, {"kind": "train", "inputs": inputs, "out": out,
                                           "grad_accum": grad_accum, "variant": variant},
                         timeout=RANK_TIMEOUT)
            self.cache[key] = [torch.load(out % r, weights_only=False) for r in range(world)]
        return self.cache[key]

    def step_forward(self, grad_accum, seed=None):
        """The step's forward for `relu_margin` on the batch of `seed` (that of
        `grad_accum` by default): each gathered microbatch is the JAX step's, and BatchNorm
        takes its statistics over all of it, as one process does."""
        cfg = R3MConfig(**self.cfg_kw)
        crops, perms = _draws(self.jstate.key, grad_accum, self.jcfg.num_negatives)
        model = model_from_jax(cfg, _np(self.jstate.params), _np(self.jstate.batch_stats))
        bert = distilbert_from_jax(_np(self.jbert), n_heads=BERT_SMALL["n_heads"])
        return step_forward(cfg, model, self._seed_batch(grad_accum, seed), perms, crops,
                            bert, grad_accum=grad_accum)

    def _seed_batch(self, grad_accum, seed):
        if seed is None or seed == BATCH_SEEDS[grad_accum]:
            return self.batches[grad_accum]
        return _batch(np.random.default_rng(seed))

    def jax_relu_inputs(self, grad_accum, seed=None):
        """The ReLU inputs of the JAX mesh step on one device on the batch of `seed`, for
        `relu_flips`; one compiled step a `grad_accum` (its gradients equal the W=2
        step's bit for bit, without the recording)."""
        key = ("relu", grad_accum, seed)
        if key not in self.cache:
            step_key = ("relu_step", grad_accum)
            mesh = jax_make_mesh(1)
            with jax_relus() as seen:
                if step_key not in self.cache:
                    self.cache[step_key] = jtrainer.make_train_step(
                        self.jcfg, self.jbert, mesh=mesh, donate=False, doaug="rctraj",
                        grad_accum=grad_accum, bert_cfg=self.bert_cfg)
                jax.block_until_ready(self.cache[step_key](
                    replicate(mesh, self.jstate),
                    shard_batch(mesh, self._seed_batch(grad_accum, seed))))
            self.cache[key] = seen
        return self.cache[key]

    def want_grads(self, jnew):
        """The JAX step's gradients in the port's names: Adam's first moment after one
        step is 0.1 times the gradient."""
        mu = jax.tree_util.tree_map(lambda m: m / 0.1, jnew.opt_state[0].mu)
        return state_dict_from_jax(mu, jnew.batch_stats, 18, data_parallel=False)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("parallel")
    yield Setup(str(d))
    shutil.rmtree(d, ignore_errors=True)  # the ranks' inputs and results


def _grad_errors(got, want):
    floor = 1e-4 * np.sqrt(sum(np.sum(want[n].double().numpy() ** 2) for n in got))
    return {n: np.linalg.norm(g.double().numpy() - want[n].double().numpy())
            / max(np.linalg.norm(want[n].double().numpy()), floor) for n, g in got.items()}


def _matches_jax(setup, ranks, world, grad_accum):
    """The failures of rank 0's results against the JAX mesh step's (an empty list if it
    matches): loss and metrics, gradients, updated parameters, BatchNorm statistics."""
    jnew, jm = setup.jax_train(world, grad_accum)
    r0 = ranks[0]
    bad = []
    for k, v in jm.items():
        if not np.isclose(float(r0["metrics"][k]), v, rtol=RTOL, atol=1e-7):
            bad.append(f"metric {k}: {float(r0['metrics'][k])} vs {v}")
    errs = _grad_errors(r0["grads"], setup.want_grads(jnew))
    bad += [f"grad {n}: relative L2 {e}" for n, e in errs.items() if e > GRAD_REL_L2]
    want = state_dict_from_jax(jnew.params, jnew.batch_stats, 18, data_parallel=False)
    floor = 1e-4 * np.sqrt(sum(np.sum(want[n].double().numpy() ** 2) for n in r0["grads"]))
    for n, t in r0["state"].items():
        if n.endswith("num_batches_tracked"):
            continue
        w = want[n].numpy()
        if n.endswith(("running_mean", "running_var")):
            if not np.allclose(t.numpy(), w, rtol=RTOL, atol=1e-6):
                bad.append(f"statistics {n}: max abs {np.abs(t.numpy() - w).max()}")
        elif np.linalg.norm(t.numpy() - w) / max(np.linalg.norm(w), floor) > GRAD_REL_L2:
            bad.append(f"parameter {n}")
    return bad


@pytest.mark.parametrize("world,grad_accum", [(2, 1), (4, 1), (2, 2), (4, 2)])
def test_dp_train_step_matches_jax_mesh(setup, world, grad_accum):
    assert_relu_margin(setup.step_forward(grad_accum), BATCH_SEEDS[grad_accum],
                       reference=setup.jax_relu_inputs(grad_accum))
    ranks = setup.port_train(world, grad_accum)
    assert _matches_jax(setup, ranks, world, grad_accum) == []
    for r in ranks[1:]:  # one global loss and one state, bit for bit, on every rank
        assert all(torch.equal(r["metrics"][k], ranks[0]["metrics"][k]) for k in r["metrics"])
        assert all(torch.equal(v, ranks[0]["state"][k]) for k, v in r["state"].items())
        assert r["step"] == 1


def test_relu_screen_rejects_the_seed_whose_jax_step_flips_a_relu(setup):
    """Seed 384 at grad_accum 2 clears the margin of the port's rounding (0.613), but the
    JAX step flips one input of layer1.1's first ReLU in the first microbatch (frame 4,
    channel 0, row 5, column 6: -8.4e-6 in f64, +4.8e-6 in JAX). The JAX step on one or
    two devices then parts from the port's steps at every world, and from its own on four
    devices, by up to 1.4e-3 in the leaves upstream of that ReLU. The screen with the JAX
    step's inputs rejects it."""
    forward = setup.step_forward(2, FLIPPED_SEED)
    assert relu_margin(forward) > RELU_ROUNDING
    flips = relu_flips(forward, setup.jax_relu_inputs(2, FLIPPED_SEED))
    assert [(call, idx) for call, idx, _, _ in flips] == [(3, (4, 0, 5, 6))]
    assert flips[0][2] < 0 < flips[0][3]
    with pytest.raises(AssertionError, match=f"seed {FLIPPED_SEED}: the JAX step puts 1"):
        assert_relu_margin(forward, FLIPPED_SEED,
                           reference=setup.jax_relu_inputs(2, FLIPPED_SEED))


@pytest.mark.parametrize("variant,broken", [
    ("summed", "grad"), ("local_bn", "metric full_loss"), ("local_bn", "statistics")])
def test_summed_gradients_or_local_batchnorm_fail_the_comparison(setup, variant, broken):
    """The comparison above sees a step that sums the gradients over the ranks instead of
    averaging them, or normalises with each rank's own BatchNorm statistics."""
    bad = _matches_jax(setup, setup.port_train(2, 1, variant), 2, 1)
    assert any(b.startswith(broken) for b in bad), bad


def test_dp_eval_step_matches_jax_mesh(setup):
    mesh = jax_make_mesh(2)
    key = jax.random.PRNGKey(3)
    perms = {k: torch.from_numpy(np.array(v)).long()
             for k, v in jax_draw_permutations(key, CLIPS, setup.jcfg.num_negatives).items()}
    eval_batch = {**setup.batch, "images": setup.batch["images"][:, :, :32, :32]}
    setup.batch, saved = eval_batch, setup.batch
    try:
        want = jtrainer.make_eval_step(setup.jcfg, setup.jbert, mesh=mesh,
                                       bert_cfg=setup.bert_cfg)(
            replicate(mesh, setup.jstate), shard_batch(mesh, eval_batch), key)
        inputs = setup.port_inputs("eval", perms=perms)
    finally:
        setup.batch = saved
    out = os.path.join(setup.tmp, "eval_rank%d.pt")
    launch_local(run_step, 2, {"kind": "eval", "inputs": inputs, "out": out},
                 timeout=RANK_TIMEOUT)
    ranks = [torch.load(out % r, weights_only=False) for r in range(2)]
    for k, v in want.items():
        np.testing.assert_allclose(float(ranks[0]["metrics"][k]), float(v), rtol=RTOL,
                                   atol=1e-7, err_msg=k)
        assert torch.equal(ranks[1]["metrics"][k], ranks[0]["metrics"][k])
    assert ranks[0]["grads"] == {} and ranks[0]["step"] == 0
    # the eval step leaves the BatchNorm statistics as they were
    start = state_dict_from_jax(_np(setup.jstate.params), _np(setup.jstate.batch_stats), 18,
                                data_parallel=False)
    for n, t in ranks[0]["state"].items():
        if n.endswith(("running_mean", "running_var")):
            assert torch.equal(t, start[n]), n


def test_collectives_carry_embeddings_moments_and_gradients_only(setup):
    """The counterpart of ``test_multichip_hlo_collective_structure``: every collective of
    a W=2, grad_accum=2 step, by kind and shape. No image tensor enters one: the
    embeddings, the language embeddings and mask are gathered, the BatchNorm moments
    (2C a layer), the embeddings' gradient and one flat gradient bucket are summed, and
    the generators are compared once; the tally counts each of them."""
    world, accum = 2, 2
    ranks = setup.port_train(world, accum)
    log, tally = ranks[0]["collectives"], ranks[0]["tally"]
    micro = CLIPS // accum // world
    n_params = sum(g.numel() for g in ranks[0]["grads"].values())
    bn_widths = {m.num_features for m in r3m_init(R3MConfig(**setup.cfg_kw)).modules()
                 if isinstance(m, torch.nn.BatchNorm2d)}
    allowed = {("all_gather", (micro, 5, 512)), ("all_gather", (micro, 768)),
               ("all_gather", (micro,)), ("all_reduce", (micro * world, 5, 512)),
               ("all_reduce", (n_params,))}
    allowed |= {("all_reduce", (2 * c,)) for c in bn_widths}
    gen = [e for e in log if e[0] == "broadcast"]
    assert len(gen) == 1 and len(gen[0][1]) == 1  # the generator's state, once
    assert set(log) - set(gen) <= allowed, set(log) - allowed
    assert all(len(shape) < 4 for _, shape in log)  # no [N, H, W, C] image
    # per microbatch: the three gathers, 20 BatchNorm layers forward and backward
    n_bn = 20
    assert sum(1 for k, _ in log if k == "all_gather") == 3 * accum
    assert sum(1 for e in log if e == ("all_reduce", (micro * world, 5, 512))) == accum
    moments = [s for k, s in log if k == "all_reduce" and len(s) == 1 and s[0] != n_params]
    assert len(moments) == 2 * n_bn * accum
    assert tally["all_gather"]["calls"] == 3 * accum
    assert tally["all_reduce"]["calls"] == sum(1 for k, _ in log if k == "all_reduce")
    assert tally["all_reduce"]["bytes"] == 4 * sum(int(np.prod(s)) for k, s in log
                                                   if k == "all_reduce")


@pytest.mark.parametrize("batch,accum,world", [(8, 1, 2), (8, 2, 2), (16, 2, 4), (8, 2, 4)])
def test_local_rows_tile_the_global_batch(batch, accum, world):
    rows = [local_rows(batch, accum, world, r) for r in range(world)]
    micro, per = batch // accum, batch // accum // world
    for m in range(accum):  # local microbatch m, gathered in rank order, is global m
        gathered = np.concatenate([r[m * per:(m + 1) * per] for r in rows])
        np.testing.assert_array_equal(gathered, np.arange(m * micro, (m + 1) * micro))


@pytest.mark.parametrize("batch,accum,world,match", [
    (8, 3, 2, "grad_accum"), (8, 2, 8, "world size"), (6, 1, 4, "world size")])
def test_local_rows_rejects_a_batch_it_cannot_tile(batch, accum, world, match):
    with pytest.raises(ValueError, match=match):
        local_rows(batch, accum, world, 0)


def test_dp_step_needs_a_process_group(setup):
    cfg = R3MConfig(**{**setup.cfg_kw, "langweight": 0.0})
    for make in (make_train_step, make_eval_step):
        with pytest.raises(RuntimeError, match="process group"):
            make(cfg, device="cpu", mesh=True)
