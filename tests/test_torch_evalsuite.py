"""The port's evaluation suite (`r3m_tpu_torch.evalsuite`) against the JAX package's, on the
CPU.

The reach-world fixture is host numpy in both packages: the rendered arrays, the JPEG
bytes and the vocabulary are equal exactly, the manifest rows equal as parsed, and the
probes' metrics agree to 1e-12. The BC probe trains its policy in f32 in both; fed the same
initial weights (the JAX `_mlp_init` carried over by `policy_params_from_jax`) and the same
minibatch indices (drawn here as the JAX scan draws them), the train curve and the
validation MSE agree to rtol 1e-5 and the trained parameters to rtol 1e-4: what is left is
the order of f32 sums in the products and Adam's arithmetic.
"""

import os
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

import jax

from r3m_tpu.evalsuite import bc as jbc
from r3m_tpu.evalsuite import fixtures as jfix
from r3m_tpu_torch.convert import policy_params_from_jax
from r3m_tpu_torch.data.ego4d import Ego4DDataset, read_manifest
from r3m_tpu_torch.evalsuite import bc, fixtures

TOL = 1e-12


@pytest.fixture(autouse=True)
def _remove_tmp_path(tmp_path):
    """Each test's temporary directory goes when the test ends: the suite's files add up."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.mark.parametrize("size", [32, 64])
def test_render_probe_set_equals_jax(size):
    want = jfix.render_probe_set(n_videos=3, n_frames=4, size=size, seed=10_000)
    got = fixtures.render_probe_set(n_videos=3, n_frames=4, size=size, seed=10_000)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_write_probe_dataset_equals_jax_and_feeds_the_sampler(tmp_path):
    want = jfix.write_probe_dataset(str(tmp_path / "jax"), n_videos=3, n_frames=4, size=32,
                                    seed=3)
    got = fixtures.write_probe_dataset(str(tmp_path / "port"), n_videos=3, n_frames=4,
                                       size=32, seed=3)
    for v in range(3):
        for t in range(1, 5):
            name = os.path.join(f"vid{v:03}", f"{t:06}.jpg")
            with open(os.path.join(want, name), "rb") as a, open(os.path.join(got, name),
                                                                 "rb") as b:
                assert a.read() == b.read(), name
    with open(os.path.join(want, "vocab.txt")) as a, open(os.path.join(got, "vocab.txt")) as b:
        assert a.read() == b.read()
    rows_want = read_manifest(os.path.join(want, "manifest.csv"))
    rows_got = read_manifest(os.path.join(got, "manifest.csv"))
    assert [(os.path.basename(r["path"]), r["len"], r["txt"]) for r in rows_got] == [
        (os.path.basename(r["path"]), r["len"], r["txt"]) for r in rows_want]
    # pandas parses the port's manifest as the JAX package's own reader does
    frame = pd.read_csv(os.path.join(got, "manifest.csv"))
    assert list(frame.columns) == ["path", "len", "txt"]
    assert list(frame["txt"]) == [r["txt"] for r in rows_want]
    ds = Ego4DDataset(got, alpha=0.2, seed=0)
    paths, captions = ds.sample_batch(2)
    assert all(os.path.exists(p) for p in paths) and len(paths) == 2 * 5
    assert all(c.startswith("person moves the block to the ") for c in captions)


@pytest.mark.parametrize("sector", range(8))
def test_dir_index_equals_jax(sector):
    (dx, dy), name = fixtures._DIRS[sector]
    for scale, jitter in ((1.0, 0.0), (7.5, 0.3), (0.01, -0.3)):
        ang = np.arctan2(dy, dx) + jitter
        delta = scale * np.array([np.cos(ang), np.sin(ang)])
        assert fixtures._dir_index(delta) == jfix._dir_index(delta) == sector
    assert fixtures._direction_phrase(np.array([dx, dy], float)) == name


def test_reward_order_acc_equals_jax():
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(17, 6))
    video = np.array([0] * 6 + [1] * 2 + [2] * 5 + [3] * 4)  # video 1: < 3 frames
    emb[13:17] = emb[13]  # video 3: a constant embedding, every pair tied
    got = fixtures.reward_order_acc(emb, video)
    assert abs(got - jfix.reward_order_acc(emb, video)) <= TOL
    assert abs(fixtures.reward_order_acc(emb[13:], video[13:]) - 0.5) <= TOL
    with pytest.raises(ValueError, match="3 frames"):
        fixtures.reward_order_acc(emb[6:8], video[6:8])


@pytest.mark.parametrize("grouped", [False, True])
def test_linear_probe_equals_jax(grouped):
    rng = np.random.default_rng(1)
    emb = rng.normal(size=(40, 12))
    target = np.stack([emb[:, :3] @ rng.normal(size=3), rng.normal(size=40)], axis=1)
    groups = np.repeat(np.arange(8), 5) if grouped else None
    got = fixtures.linear_probe(emb, target, groups=groups, seed=2)
    want = jfix.linear_probe(emb, target, groups=groups, seed=2)
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= TOL * max(1.0, abs(want[k])), k


def test_caption_contrast_acc_takes_a_tensor_score():
    rng = np.random.default_rng(2)
    e_first = rng.normal(size=(6, 5)).astype(np.float32)
    e_last = rng.normal(size=(6, 5)).astype(np.float32)
    deltas = rng.normal(size=(6, 2))
    caps = fixtures.probe_captions()

    def score(e0, es, sentences):  # deterministic: prefers the caption of the motion
        s = np.array([float(np.sum(a * b)) for a, b in zip(e0, es)])
        idx = np.array([caps.index(c) for c in sentences])
        truth = np.repeat([fixtures._dir_index(d) for d in deltas], len(caps))
        return s * 0.0 + (idx == truth) * 1.0 + 0.01 * (idx % 3)

    want = jfix.caption_contrast_acc(score, e_first, e_last, deltas)
    got = fixtures.caption_contrast_acc(
        lambda *a: torch.as_tensor(score(*a)), torch.from_numpy(e_first), e_last, deltas)
    assert want == 1.0 and abs(got - want) <= TOL
    wrong = fixtures.caption_contrast_acc(
        lambda *a: torch.as_tensor(-score(*a)), e_first, e_last, deltas)
    assert abs(wrong - jfix.caption_contrast_acc(lambda *a: -score(*a), e_first, e_last,
                                                 deltas)) <= TOL


def _jax_draws(seed, n_features, n_actions, hidden, steps, batch, n_train):
    """The JAX probe's initial policy and minibatch indices for `seed`, as its code draws
    them: `_mlp_init(PRNGKey(seed))`, and one `randint` a step over `split(key, steps)`."""
    key = jax.random.PRNGKey(seed)
    params = jax.tree_util.tree_map(
        np.asarray, jbc._mlp_init(key, [n_features, hidden, hidden, n_actions]))
    idx = np.stack([np.asarray(jax.random.randint(k, (batch,), 0, n_train))
                    for k in jax.random.split(key, steps)])
    return params, idx


def _demo(n=48, d=10, a=3, seed=3):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(n, d)).astype(np.float32)
    actions = np.tanh(emb[:, :a] + 0.5 * emb[:, a:2 * a]).astype(np.float32)
    return emb, actions


def test_bc_probe_matches_jax_with_the_same_draws():
    emb, actions = _demo()
    # lr 1e-4: Adam moves a weight whose gradient is rounding noise by ~lr either way, so
    # at the default 1e-3 the curves drift apart by ~1e-5 within 40 steps; here by ~1.5e-6
    kw = dict(hidden=32, steps=40, lr=1e-4, batch=16, val_frac=0.25, seed=5)
    want = jbc.bc_probe(lambda x: x, emb, actions, **kw)
    n_train = emb.shape[0] - int(emb.shape[0] * kw["val_frac"])
    init, idx = _jax_draws(kw["seed"], emb.shape[1], actions.shape[1], kw["hidden"],
                           kw["steps"], kw["batch"], n_train)
    got = bc.bc_probe(lambda x: torch.as_tensor(x), emb, actions, device="cpu",
                      init_params=init, batch_indices=idx, **kw)
    np.testing.assert_allclose(got["train_mse_curve"], want["train_mse_curve"], rtol=1e-5)
    np.testing.assert_allclose(got["val_mse"], want["val_mse"], rtol=1e-5)
    assert got["train_mse"] == got["train_mse_curve"][-1]
    assert got["embed_dim"] == want["embed_dim"] == emb.shape[1]
    trained = policy_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                            want["policy_params"]))
    for p, w in zip(got["policy_params"].parameters(), trained.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), w.detach().numpy(), rtol=1e-4,
                                   atol=1e-7)
    e = emb[:5]
    np.testing.assert_allclose(
        got["policy_apply"](got["policy_params"], e).detach().numpy(),
        np.asarray(want["policy_apply"](want["policy_params"], e)), rtol=1e-4, atol=1e-6)
    assert got["train_mse_curve"][-1] < got["train_mse_curve"][0]  # it learns


def test_bc_probe_concatenates_proprio():
    emb, actions = _demo(n=12)
    proprio = np.random.default_rng(4).normal(size=(12, 7)).astype(np.float32)
    res = bc.bc_probe(lambda x: x, emb, actions, proprio=proprio, hidden=8, steps=3,
                      device="cpu")
    assert res["embed_dim"] == emb.shape[1] + 7
    assert res["policy_params"][0].in_features == emb.shape[1] + 7
    assert res["train_mse_curve"].shape == (3,)


def test_bc_probe_chunked_embed_matches_single_pass():
    calls = []

    def embed_fn(x):
        calls.append(x.shape[0])
        return torch.as_tensor(np.asarray(x).reshape(x.shape[0], -1)[:, :7])

    images = np.random.default_rng(0).normal(size=(10, 3, 4, 4)).astype(np.float32)
    out = bc._embed_chunked(embed_fn, images, chunk=4)
    assert isinstance(out, np.ndarray)
    np.testing.assert_array_equal(out, images.reshape(10, -1)[:, :7])
    np.testing.assert_array_equal(out, bc._embed_chunked(embed_fn, images, chunk=16))
    assert calls == [4, 4, 4, 10]  # fixed shape, the tail padded, then one pass


def test_bc_probe_rejects_degenerate_split():
    with pytest.raises(ValueError, match="no training samples"):
        bc.bc_probe(lambda x: x.reshape(1, -1)[:, :5], np.zeros((1, 3, 4, 4), np.float32),
                    np.zeros((1, 2), np.float32), steps=2, device="cpu")


def test_bc_probe_draws_are_its_own_and_deterministic():
    emb, actions = _demo(n=20)
    torch.manual_seed(123)
    before = torch.random.get_rng_state()
    runs = [bc.bc_probe(lambda x: x, emb, actions, hidden=8, steps=6, batch=5, seed=s,
                        device="cpu") for s in (7, 7, 8)]
    assert torch.equal(torch.random.get_rng_state(), before)
    np.testing.assert_array_equal(runs[0]["train_mse_curve"], runs[1]["train_mse_curve"])
    assert not np.array_equal(runs[0]["train_mse_curve"], runs[2]["train_mse_curve"])
    for p, q in zip(runs[0]["policy_params"].parameters(),
                    runs[1]["policy_params"].parameters()):
        assert torch.equal(p, q)
    init = bc._mlp_init([400, 300, 2], torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(layer.bias, torch.zeros_like(layer.bias)) for layer in init)
    std = init[0].weight.std().item()  # He-normal: N(0, 2 / fan_in)
    assert abs(std / np.sqrt(2.0 / 400) - 1) < 0.02
    with pytest.raises(ValueError, match="batch_indices"):
        bc.bc_probe(lambda x: x, emb, actions, hidden=8, steps=6, batch=5, device="cpu",
                    batch_indices=np.zeros((5, 5), np.int64))


def test_bc_probe_is_exported_lazily():
    import r3m_tpu_torch

    assert "bc_probe" in r3m_tpu_torch.__all__
    assert r3m_tpu_torch.bc_probe is bc.bc_probe
