"""The port's training modules against the JAX package, one module at a time, on the CPU.

The same inputs, made from a numpy seed, go through the JAX function and the port's; JAX
weights are carried over with `r3m_tpu_torch.convert`. Permutations and crop rectangles,
which the two packages' generators would draw differently, are handed to both.
Tolerances: f32 values agree to rtol 1e-5 unless a test says otherwise, and gradients to
relative L2 error 1e-4; what is left is the order of f32 sums.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from r3m_tpu import losses as jlosses
from r3m_tpu.data import augment as jaugment
from r3m_tpu.models.distilbert import DistilBertConfig as JaxBertConfig
from r3m_tpu.models.distilbert import distilbert_init, sentence_embedding as jax_sentence
from r3m_tpu.models.language_reward import language_reward_apply, language_reward_init
from r3m_tpu.models.r3m import R3MConfig as JaxR3MConfig
from r3m_tpu.training.trainer import make_optimizer as jax_make_optimizer
from r3m_tpu.utils.misc import schedule_fn as jax_schedule_fn
from r3m_tpu_torch import losses
from r3m_tpu_torch.convert import distilbert_from_jax, distilbert_state_from_jax
from r3m_tpu_torch.data.augment import (
    random_resized_crop_clips,
    resized_crop,
    sample_crop_params,
)
from r3m_tpu_torch.models.distilbert import DistilBert, DistilBertConfig, sentence_embedding
from r3m_tpu_torch.models.language_reward import LanguageReward
from r3m_tpu_torch.models.r3m import R3MConfig
from r3m_tpu_torch.training.trainer import Lars, make_optimizer
from r3m_tpu_torch.utils.misc import schedule_fn

BERT_SMALL = dict(vocab_size=100, dim=768, n_layers=1, n_heads=4, hidden_dim=128,
                  max_position_embeddings=16)


def _np(x) -> np.ndarray:
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel_l2(got, want) -> float:
    got, want = _np(got).astype(np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _lang_rew(params, im_dim, hidden, lang_dim) -> LanguageReward:
    """The JAX reward head's weights ([in, out] dense layers) in a `LanguageReward`."""
    head = LanguageReward(im_dim, hidden, lang_dim)
    sd = {}
    for i, layer in zip((0, 2, 4, 6, 8), params["layers"]):
        sd[f"pred.{i}.weight"] = torch.from_numpy(np.asarray(layer["w"]).T.copy())
        sd[f"pred.{i}.bias"] = torch.from_numpy(np.array(layer["b"]))
    head.load_state_dict(sd)
    return head


def test_language_reward_matches_jax(rng):
    params = language_reward_init(jax.random.PRNGKey(0), 16, 32, lang_dim=24)
    e0, eg = (rng.standard_normal((6, 16), dtype=np.float32) for _ in range(2))
    le = rng.standard_normal((6, 24), dtype=np.float32)
    want = np.asarray(language_reward_apply(params, e0, eg, le))
    port = _lang_rew(params, 16, 32, 24)
    assert [k for k in port.state_dict()] == [
        f"pred.{i}.{w}" for i in (0, 2, 4, 6, 8) for w in ("weight", "bias")
    ]
    got = port(*(torch.from_numpy(a) for a in (e0, eg, le)))
    assert got.shape == (6,)
    np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-6)


def test_sentence_embedding_matches_jax(rng):
    """BERT_SMALL with padded captions: the mean pools over every token, padding
    included, and padded keys are masked with finfo.min."""
    jparams = distilbert_init(jax.random.PRNGKey(7), JaxBertConfig(**BERT_SMALL))
    ids = rng.integers(0, 100, (4, 12)).astype(np.int32)
    mask = np.ones((4, 12), np.int32)
    mask[1, 7:] = 0
    mask[3, 2:] = 0
    want = np.asarray(jax_sentence(jparams, ids, mask, JaxBertConfig(**BERT_SMALL)))
    bert = distilbert_from_jax(jax.tree_util.tree_map(np.asarray, jparams), n_heads=4)
    assert bert.cfg == DistilBertConfig(**BERT_SMALL)
    assert set(distilbert_state_from_jax(jparams)) == set(DistilBert(bert.cfg).state_dict())
    assert not any(p.requires_grad for p in bert.parameters())
    got = sentence_embedding(bert, torch.from_numpy(ids).long(), torch.from_numpy(mask))
    np.testing.assert_allclose(_np(got), want, rtol=1e-4, atol=1e-5)


def _embeddings(rng, bs=6, d=8):
    """[B, 5, D] embeddings with exact zeros: a whole zero row (the L1 penalty's fixed
    point) and equal frames, so `safe_l2_norm` meets 0 in the TCN differences."""
    emb = rng.standard_normal((bs, 5, d)).astype(np.float32)
    emb[0, 2] = 0.0  # es0 of clip 0 is exactly zero
    emb[1, 3] = emb[1, 4]  # es1 == es2 in clip 1
    emb[2, :, :3] = 0.0
    return emb


def _perms(bs, num_neg):
    """Permutations with fixed points (index 0 maps to itself in each)."""
    rng = np.random.default_rng(5)
    lang = np.stack([np.concatenate([[0], 1 + rng.permutation(bs - 1)])
                     for _ in range(num_neg * 3)]).reshape(num_neg, 3, bs)
    tcn = np.stack([np.concatenate([[0], 1 + rng.permutation(bs - 1)])
                    for _ in range(num_neg * 2)]).reshape(num_neg, 2, bs)
    return {"lang": lang.astype(np.int32), "tcn": tcn.astype(np.int32)}


@pytest.mark.parametrize("l2dist", [True, False])
def test_losses_and_their_gradients_match_jax(rng, l2dist):
    """`r3m_loss` (lp_norms, language_loss, tcn_loss): every metric, and the gradient
    with respect to the embeddings and the reward head, with zero embeddings and fixed
    points; no NaN reaches a gradient."""
    kw = dict(size=18, hidden_dim=16, langweight=1.0, tcnweight=1.0, l2dist=l2dist,
              num_negatives=3, lang_dim=12)
    jcfg, cfg = JaxR3MConfig(**kw), R3MConfig(**kw)
    bs = 6
    emb = _embeddings(rng, bs)
    lang = rng.standard_normal((bs, 12)).astype(np.float32)
    lang_mask = np.array([1, 1, 0, 1, 1, 1], np.float32)
    perms = _perms(bs, 3)
    jparams = {"lang_rew": language_reward_init(jax.random.PRNGKey(1), 8, 16, 12)}

    def jloss(p, e):
        return jlosses.r3m_loss(jcfg, p, e, lang, lang_mask, perms)

    (want_loss, want_m), (want_gp, want_ge) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jparams, emb)

    head = _lang_rew(jparams["lang_rew"], 8, 16, 12)
    e = torch.from_numpy(emb).requires_grad_(True)
    loss, m = losses.r3m_loss(
        cfg, head, e, torch.from_numpy(lang), torch.from_numpy(lang_mask),
        {k: torch.from_numpy(v).long() for k, v in perms.items()},
    )
    loss.backward()
    assert set(m) == set(want_m)
    for k in want_m:
        np.testing.assert_allclose(_np(m[k]), np.asarray(want_m[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert torch.isfinite(e.grad).all()
    assert _rel_l2(e.grad, want_ge) < 1e-4
    # The last bias's gradient is the sum of d(loss)/d(score) over every score, which
    # the InfoNCE softmax cancels to rounding noise; it is held to 1e-4 of the head's
    # largest leaf instead of to its own norm.
    pairs = [(head.pred[i].weight.grad.T, layer["w"]) for i, layer in
             zip((0, 2, 4, 6, 8), want_gp["lang_rew"]["layers"])]
    pairs += [(head.pred[i].bias.grad, layer["b"]) for i, layer in
              zip((0, 2, 4, 6, 8), want_gp["lang_rew"]["layers"])]
    floor = max(np.linalg.norm(np.asarray(w)) for _, w in pairs)
    for got, want in pairs:
        err = np.linalg.norm(_np(got) - np.asarray(want))
        assert err <= 1e-4 * max(np.linalg.norm(np.asarray(want)), floor)


def test_tcn_loss_without_negatives_matches_jax(rng):
    kw = dict(size=18, num_negatives=0)
    emb = _embeddings(rng, 4)
    perms = {"tcn": np.zeros((0, 2, 4), np.int32)}
    want, wm = jlosses.tcn_loss(JaxR3MConfig(**kw), emb[:, 2], emb[:, 3], emb[:, 4],
                                perms["tcn"])
    got, gm = losses.tcn_loss(R3MConfig(**kw), *(torch.from_numpy(emb[:, i]) for i in (2, 3, 4)),
                              torch.zeros((0, 2, 4), dtype=torch.long))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5)
    np.testing.assert_allclose(_np(gm["aligned"]), np.asarray(wm["aligned"]))


def test_draw_permutations_shapes_and_determinism():
    g = torch.Generator().manual_seed(3)
    p = losses.draw_permutations(g, 7, 3)
    assert p["lang"].shape == (3, 3, 7) and p["tcn"].shape == (3, 2, 7)
    for row in torch.cat([p["lang"].reshape(-1, 7), p["tcn"].reshape(-1, 7)]):
        assert sorted(row.tolist()) == list(range(7))
    again = losses.draw_permutations(torch.Generator().manual_seed(3), 7, 3)
    assert all(torch.equal(p[k], again[k]) for k in p)
    empty = losses.draw_permutations(g, 7, 0)
    assert empty["lang"].shape == (0, 3, 7) and empty["tcn"].shape == (0, 2, 7)


def _jax_rects(n, h, w, seed=0):
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    return np.stack([np.array(jaugment.sample_crop_params(k, h, w)) for k in keys])


IMAGENET = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("norm", [False, True])
def test_resized_crop_matches_jax(rng, dt, norm):
    """Crop rectangles drawn by the JAX law, injected into both. In bf16 both packages
    round the weights, the row product and the normalisation to bf16, each summing in
    its own order: they agree to a few bf16 steps of values of order 1 (255 unnormalised)."""
    h, w, out = 37, 45, 16
    imgs = rng.integers(0, 256, (6, h, w, 3)).astype(np.uint8)
    rects = _jax_rects(6, h, w)
    rects[0] = (0, 0, h, w)  # the whole frame
    rects[1] = (30, 40, 5, 3)  # a small crop at the corner, upscaled
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    mean, std = IMAGENET if norm else (None, None)
    want = np.stack([
        np.asarray(jaugment.resized_crop(jnp.asarray(im), *r, out, jdt, mean, std)
                   .astype(jnp.float32))
        for im, r in zip(imgs, rects)
    ])
    got = resized_crop(torch.from_numpy(imgs), torch.from_numpy(rects), out, tdt, mean, std)
    assert got.dtype == tdt and tuple(got.shape) == (6, out, out, 3)
    scale = 1.0 if norm else 255.0
    tol = {"f32": 1e-5, "bf16": 3e-2}[dt] * scale
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=tol)


@pytest.mark.parametrize("mode", ["rctraj", "rc", "none"])
def test_random_resized_crop_clips_matches_jax_with_its_rectangles(rng, mode):
    """The clip-level modes, with the rectangles the JAX function draws from its key."""
    b, f, h, w, out = 3, 5, 24, 30, 16
    if mode == "none":
        h = w = out
    clips = rng.integers(0, 256, (b, f, h, w, 3)).astype(np.uint8)
    key = jax.random.PRNGKey(4)
    mean, std = IMAGENET
    want = np.asarray(jaugment.random_resized_crop_clips(
        key, jnp.asarray(clips), out_size=out, mode=mode, mean=mean, std=std))
    rects = None
    if mode == "rctraj":
        rects = np.stack([np.array(jaugment.sample_crop_params(k, h, w))
                          for k in jax.random.split(key, b)])
    elif mode == "rc":
        keys = jax.random.split(key, b * f)
        rects = np.stack([np.array(jaugment.sample_crop_params(k, h, w))
                          for k in keys]).reshape(b, f, 4)
    got = random_resized_crop_clips(
        torch.from_numpy(clips), out, mode,
        rects=None if rects is None else torch.from_numpy(rects), mean=mean, std=std,
    )
    assert tuple(got.shape) == (b, f, out, out, 3)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-5)


def test_sample_crop_params_follows_torchvisions_law():
    """Drawn rectangles lie inside the frame with area in [0.2, 1] of it and aspect in
    [3/4, 4/3] (up to rounding); where no attempt can succeed, both packages return the
    same ratio-clamped centre crop."""
    g = torch.Generator().manual_seed(0)
    r = sample_crop_params(g, 2000, 120, 160).numpy()
    i, j, h, w = r.T
    assert (i >= 0).all() and (j >= 0).all() and (i + h <= 120).all() and (j + w <= 160).all()
    area = h * w / (120 * 160)
    assert area.min() > 0.18 and area.max() <= 1.0 and np.median(area) > 0.4
    assert (w / h).min() > 0.7 and (w / h).max() < 1.4
    assert np.array_equal(r, sample_crop_params(torch.Generator().manual_seed(0), 2000,
                                                120, 160).numpy())
    for hgt, wid in ((1, 100), (100, 1)):  # every attempt is invalid
        want = np.array(jaugment.sample_crop_params(jax.random.PRNGKey(0), hgt, wid))
        got = sample_crop_params(torch.Generator().manual_seed(0), 3, hgt, wid).numpy()
        np.testing.assert_array_equal(got, np.broadcast_to(want, (3, 4)))


@pytest.mark.parametrize("spec", ["3e-4", "linear(1e-3,1e-5,100)",
                                  "step_linear(1e-3,1e-4,50,1e-5,100)"])
def test_schedule_fn_matches_jax(spec):
    steps = [0, 1, 25, 49, 50, 51, 99, 100, 150, 1000]
    got = [schedule_fn(spec)(s) for s in steps]
    want = [float(jax_schedule_fn(spec)(s)) for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    with pytest.raises(NotImplementedError):
        schedule_fn("cosine(1,2)")


@pytest.mark.parametrize("optimizer,lr,wd", [
    ("adam", "linear(1e-2,1e-3,4)", 0.0),
    ("lars", 0.5, 1e-2),
    ("lars", "linear(1.0,0.1,4)", 0.0),
])
def test_optimizers_match_optax_over_two_steps(rng, optimizer, lr, wd):
    """Adam (torch.optim.Adam) and `Lars` against optax, fed the same gradients twice.
    A schedule's first update takes lr(0). LARS exempts 1-D leaves from weight decay and
    the trust ratio; a zero-gradient leaf takes ratio 1. Parameters of order 1 agree to
    f32 rounding of the updates (atol 1e-6)."""
    shapes = {"conv": (3, 3, 4, 5), "dense": (6, 7), "bias": (7,), "scale": (5,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(2)]
    grads[1]["dense"][:] = 0.0
    kw = dict(size=18, optimizer=optimizer, lr=lr, weight_decay=wd)
    tx = jax_make_optimizer(JaxR3MConfig(**kw))
    jp, state = params, tx.init(params)
    for g in grads:
        upd, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, upd)

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = make_optimizer(R3MConfig(**kw), list(tp.values()))
    assert isinstance(opt, Lars if optimizer == "lars" else torch.optim.Adam)
    for n, g in enumerate(grads):
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        for group in opt.param_groups:
            group["lr"] = schedule_fn(lr)(n)
        opt.step()
    for k in shapes:
        np.testing.assert_allclose(_np(tp[k]), np.asarray(jp[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
