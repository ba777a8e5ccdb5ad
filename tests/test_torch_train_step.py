"""The port's whole pretraining step against the JAX `make_train_step`, on the CPU.

One ResNet-18 step (hidden 64, 32 px crops of 40x48 frames, BatchNorm unpacked, 4 clips,
rctraj, BERT_SMALL) and one ViT-B/32 step (64 px) start from the same state (the JAX
state carried over with `r3m_tpu_torch.convert`) and take the same batch, permutations
and crop rectangles: the JAX step derives them from ``state.key`` (``trainer.py:256,266,
316``), and this file derives them the same way and hands them to the port.

The JAX gradients come from ``jax.value_and_grad`` of the function the JAX step
differentiates (``_encode_and_loss``), fed the same augmented frames and permutations.

Tolerances, f32 throughout: the loss and every metric to rtol 1e-4; every gradient leaf
to relative L2 error 1e-3; BatchNorm running statistics to rtol 1e-4 (atol 1e-6); the
second step's loss to rtol 1e-4. What is left is the order of f32 sums (and JAX's
E[x^2] - E[x]^2 batch variance against torch's two-pass one).

Two things that rounding can do are kept out of the comparison. A ReLU whose input lands
within rounding of 0 passes the gradient in one package and blocks it in the other; at
this size one such element moves every leaf upstream of it by ~3e-3 (the batch of seed 0
has one, in ``layer2.1``). The batches here come from seeds without one; their worst leaf
is ~5e-5. Each test asserts that premise on its own batch before it compares
(``tests/test_torch_relu_margin.py``). And a leaf whose gradient cancels to rounding
noise (the reward head's last bias: the InfoNCE gradients of the scores sum to ~0) is
measured against a floor of 1e-4 of the global gradient norm rather than against its own
norm.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from r3m_tpu.data import augment as jaugment
from r3m_tpu.losses import draw_permutations as jax_draw_permutations
from r3m_tpu.models.distilbert import DistilBertConfig as JaxBertConfig
from r3m_tpu.models.distilbert import distilbert_init
from r3m_tpu.models.r3m import R3MConfig as JaxR3MConfig
from r3m_tpu.training import trainer as jtrainer
from r3m_tpu_torch.convert import distilbert_from_jax, model_from_jax, state_dict_from_jax
from r3m_tpu_torch.models.r3m import R3MConfig
from r3m_tpu_torch.training.trainer import create_train_state, make_eval_step, make_train_step
from tests.test_torch_relu_margin import (
    RELU_ROUNDING,
    assert_relu_margin,
    relu_margin,
    step_forward,
)

BERT_SMALL = dict(vocab_size=100, dim=768, n_layers=1, n_heads=4, hidden_dim=128,
                  max_position_embeddings=16)
CLIPS, FRAME_HW, TOKENS = 4, (40, 48), 12
RTOL = 1e-4
GRAD_REL_L2 = 1e-3


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(rng):
    mask = np.ones((CLIPS, TOKENS), np.int32)
    mask[1, 7:] = 0
    mask[3, 3:] = 0
    return {
        "images": rng.integers(0, 256, (CLIPS, 5, *FRAME_HW, 3)).astype(np.uint8),
        "token_ids": rng.integers(0, 100, (CLIPS, TOKENS)).astype(np.int32),
        "attn_mask": mask,
        "lang_mask": np.array([1, 1, 0, 1], np.float32),
    }


def _draws(key, bs, grad_accum, num_neg):
    """What the JAX step draws from `key`: rctraj rectangles [bs, 4] and one permutation
    set per microbatch, as numpy; and the key of the next step."""
    perm_key, aug_key, next_key = jax.random.split(key, 3)
    rects = np.stack([np.array(jaugment.sample_crop_params(k, *FRAME_HW))
                      for k in jax.random.split(aug_key, bs)])
    if grad_accum == 1:
        keys, micro = [perm_key], bs
    else:
        keys, micro = list(jax.random.split(perm_key, grad_accum)), bs // grad_accum
    perms = [{k: torch.from_numpy(np.array(v)).long()
              for k, v in jax_draw_permutations(pk, micro, num_neg).items()} for pk in keys]
    return aug_key, rects, perms, next_key


def _assert_metrics(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL, atol=1e-7,
                                   err_msg=k)


def _assert_bn_stats(model, jparams, jstats, size):
    want = state_dict_from_jax(_tree_np(jparams), _tree_np(jstats), size,
                               data_parallel=False)
    got = model.state_dict()
    names = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert names or size == 0
    for k in names:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=RTOL, atol=1e-6,
                                   err_msg=k)


class Setup:
    """A JAX config, state and frozen BERT, and the same state carried to the port."""

    def __init__(self, size, image_size):
        kw = dict(size=size, hidden_dim=64, l2weight=1e-5, l1weight=1e-5, tcnweight=1.0,
                  langweight=1.0, image_size=image_size, packed_bn=False)
        self.size = size
        self.jcfg, self.cfg = JaxR3MConfig(**kw), R3MConfig(**kw)
        self.bert_cfg = JaxBertConfig(**BERT_SMALL)
        self.jbert = distilbert_init(jax.random.PRNGKey(7), self.bert_cfg)
        self.bert = distilbert_from_jax(_tree_np(self.jbert), n_heads=BERT_SMALL["n_heads"])
        self.jstate = jtrainer.create_train_state(self.jcfg, jax.random.PRNGKey(0))

    def jax_step(self, grad_accum=1):
        return jtrainer.make_train_step(self.jcfg, self.jbert, donate=False, doaug="rctraj",
                                        grad_accum=grad_accum, bert_cfg=self.bert_cfg)

    def port_state(self):
        s = self.jstate
        model = model_from_jax(self.cfg, _tree_np(s.params), _tree_np(s.batch_stats))
        return create_train_state(self.cfg, 0, model=model, device="cpu")

    def jax_grads(self, batch, aug_key, perms):
        """The JAX loss, metrics and gradients at the initial state."""
        mean, std = self.jcfg.norm_stats
        images = jaugment.random_resized_crop_clips(
            aug_key, jnp.asarray(batch["images"]), out_size=self.jcfg.image_size,
            mode="rctraj", mean=mean, std=std)
        jperms = {k: jnp.asarray(v.numpy(), jnp.int32) for k, v in perms.items()}

        def loss_fn(params):
            loss, metrics, _ = jtrainer._encode_and_loss(
                self.jcfg, params, self.jstate.batch_stats, self.jbert,
                {**batch, "images": images}, jperms, True, True, self.bert_cfg)
            return loss, metrics

        (_, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            self.jstate.params)
        return metrics, grads

    def assert_grads(self, model, grads):
        """Every trainable leaf of the port against the JAX gradient tree, carried to the
        port's names and layouts by the same converter as the weights."""
        want = state_dict_from_jax(_tree_np(grads), _tree_np(self.jstate.batch_stats),
                                   self.size, data_parallel=False)
        params = dict(model.named_parameters())
        assert set(params) <= set(want)
        floor = 1e-4 * np.sqrt(sum(np.sum(want[n].double().numpy() ** 2) for n in params))
        for name, p in params.items():
            assert p.grad is not None, name
            w = want[name].double().numpy()
            err = np.linalg.norm(p.grad.double().numpy() - w) / max(np.linalg.norm(w), floor)
            assert err <= GRAD_REL_L2, f"{name}: relative L2 error {err}"


@pytest.fixture(scope="module")
def resnet():
    return Setup(18, 32)


@pytest.fixture(scope="module")
def vit():
    return Setup(0, 64)


@pytest.mark.parametrize("backbone", ["resnet", "vit"])
def test_train_step_matches_jax(request, backbone):
    """Step 1: loss, every metric (grad_norm included), every gradient leaf and the new
    BatchNorm statistics; step 2: the loss, after one Adam update on each side."""
    s = request.getfixturevalue(backbone)
    batch = _batch(np.random.default_rng(3))
    aug_key, rects, perms, key2 = _draws(s.jstate.key, CLIPS, 1, s.cfg.num_negatives)
    _, rects2, perms2, _ = _draws(key2, CLIPS, 1, s.cfg.num_negatives)

    jstep = s.jax_step()
    jstate1, jm1 = jstep(s.jstate, batch)
    _, jm2 = jstep(jstate1, batch)
    want_m, grads = s.jax_grads(batch, aug_key, perms[0])
    np.testing.assert_allclose(float(want_m["full_loss"]), float(jm1["full_loss"]),
                               rtol=1e-6)

    state = s.port_state()
    assert_relu_margin(step_forward(s.cfg, state.model, batch, perms[0], rects, s.bert), 3)
    step = make_train_step(s.cfg, s.bert, doaug="rctraj", device="cpu")
    state, m1 = step(state, batch, perms=perms[0], crops=torch.from_numpy(rects))
    _assert_metrics(m1, jm1)
    s.assert_grads(state.model, grads)
    _assert_bn_stats(state.model, jstate1.params, jstate1.batch_stats, s.size)
    assert state.step == 1

    state, m2 = step(state, batch, perms=perms2[0], crops=torch.from_numpy(rects2))
    np.testing.assert_allclose(float(m2["full_loss"]), float(jm2["full_loss"]), rtol=RTOL)
    assert state.step == 2


def test_grad_accum_matches_jax(resnet):
    """grad_accum=2: per-microbatch BatchNorm statistics and negatives, the mean of the
    two gradients (its global norm is a metric), one update. On the batch of seed 2: seed
    1's puts a ReLU input within rounding of 0 in its microbatches (margin 0.146)."""
    s = resnet
    batch = _batch(np.random.default_rng(2))
    _, rects, perms, _ = _draws(s.jstate.key, CLIPS, 2, s.cfg.num_negatives)
    jstate1, jm = s.jax_step(grad_accum=2)(s.jstate, batch)

    state = s.port_state()
    assert_relu_margin(step_forward(s.cfg, state.model, batch, perms, rects, s.bert,
                                    grad_accum=2), 2)
    step = make_train_step(s.cfg, s.bert, doaug="rctraj", grad_accum=2, device="cpu")
    state, m = step(state, batch, perms=perms, crops=torch.from_numpy(rects))
    _assert_metrics(m, jm)
    _assert_bn_stats(state.model, jstate1.params, jstate1.batch_stats, s.size)
    with pytest.raises(ValueError, match="grad_accum"):
        make_train_step(s.cfg, s.bert, doaug="rctraj", grad_accum=3, device="cpu")(
            state, batch, crops=torch.from_numpy(rects))


def test_eval_step_matches_jax_and_leaves_the_state(resnet):
    s = resnet
    rng = np.random.default_rng(2)
    batch = _batch(rng)
    batch["images"] = rng.integers(0, 256, (CLIPS, 5, 32, 32, 3)).astype(np.uint8)
    key = jax.random.PRNGKey(3)
    want = jtrainer.make_eval_step(s.jcfg, s.jbert, bert_cfg=s.bert_cfg)(s.jstate, batch, key)
    perms = {k: torch.from_numpy(np.array(v)).long()
             for k, v in jax_draw_permutations(key, CLIPS, s.cfg.num_negatives).items()}

    state = s.port_state()
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    got = make_eval_step(s.cfg, s.bert, device="cpu")(state, batch, perms=perms)
    _assert_metrics(got, want)
    assert state.step == 0
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_step_rejects_what_it_does_not_take(resnet):
    s = resnet
    with pytest.raises(ValueError, match="doaug"):
        make_train_step(s.cfg, s.bert, doaug="flip", device="cpu")
    with pytest.raises(ValueError, match="bert"):
        make_train_step(s.cfg, None, device="cpu")
    with pytest.raises(ValueError, match="remat"):
        cfg = dataclasses.replace(s.cfg, remat="blocks")
        make_train_step(cfg, s.bert, doaug="rctraj", device="cpu")(
            create_train_state(cfg, 0, device="cpu"), _batch(np.random.default_rng(3)))


def test_the_margin_catches_the_seed_with_a_relu_flip(resnet):
    """Seed 0's batch has a ReLU input within rounding of 0 in ``layer2.1``, which moves
    the port's gradients 6.6e-3 from the JAX package's: its margin is under the scale."""
    s = resnet
    aug_key, rects, perms, _ = _draws(s.jstate.key, CLIPS, 1, s.cfg.num_negatives)
    forward = step_forward(s.cfg, s.port_state().model, _batch(np.random.default_rng(0)),
                           perms[0], rects, s.bert)
    assert relu_margin(forward) < RELU_ROUNDING
