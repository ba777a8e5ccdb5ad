"""The port's native snapshots against the JAX package's, on the CPU.

Both packages write one ``.npz`` format, so each reads the other's files: the path encoding
(`save_snapshot` / `load_snapshot`), train snapshots (a JAX state resumes in the port and
the port's next step matches the JAX step; a port state loads in the JAX package with
every leaf equal), serving from a snapshot (`load_r3m_from_snapshot`), and the reference's
torch snapshots in both directions. The step comparisons use the tolerances of
``tests/test_torch_train_step.py`` (f32): loss rtol 1e-4, gradient leaves relative L2
1e-3, BatchNorm statistics rtol 1e-4.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from r3m_tpu import checkpoint as jckpt
from r3m_tpu import load_r3m_from_snapshot as jax_load_r3m_from_snapshot
from r3m_tpu.data import augment as jaugment
from r3m_tpu.losses import draw_permutations as jax_draw_permutations
from r3m_tpu.models.distilbert import DistilBertConfig as JaxBertConfig
from r3m_tpu.models.distilbert import distilbert_init
from r3m_tpu.models.r3m import R3MConfig as JaxR3MConfig
from r3m_tpu.training import trainer as jtrainer
from r3m_tpu_torch import checkpoint as ckpt
from r3m_tpu_torch import load_r3m_from_files, load_r3m_from_snapshot
from r3m_tpu_torch.convert import distilbert_from_jax, state_dict_from_jax
from r3m_tpu_torch.models.r3m import R3MConfig
from r3m_tpu_torch.training.trainer import create_train_state, make_train_step
from tests.test_torch_relu_margin import assert_relu_margin, step_forward

BERT_SMALL = dict(vocab_size=100, dim=768, n_layers=1, n_heads=4, hidden_dim=128,
                  max_position_embeddings=16)
CLIPS, FRAME_HW, TOKENS = 4, (40, 48), 12
RTOL = 1e-4
GRAD_REL_L2 = 1e-3
# A schedule that halves the rate after one step, so that a step count lost on resume
# shows in the update.
OPTIMIZERS = [("adam", 1e-4), ("adam", "linear(1e-4,1e-5,2)"), ("lars", 1e-3)]
# The batch of each resume case: seeds whose second step has no ReLU input within
# rounding of 0, which would pass the gradient in one package and block it in the other
# (tests/test_torch_train_step.py says more; such a flip moves conv1's gradient by 0.2-4%).
# The resume test asserts it (tests/test_torch_relu_margin.py). Seeds 3 and 9 did not
# (margins 0.0225 and 0.121 at state 1); of seeds 0-15, these have the widest margins at
# state 1 (0.71 after the Adam step, 0.463 after the LARS one).
RESUME_BATCH_SEED = {"adam": 12, "lars": 13}


@pytest.fixture(autouse=True)
def _remove_tmp_path(tmp_path):
    """Each test's temporary directory goes when the test ends: the suite's files add up."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _canonical(params, batch_stats):
    tree = jckpt.canonicalize_train_tree({"params": params, "batch_stats": batch_stats})
    return _np(tree["params"]), _np(tree["batch_stats"])


def _assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_equal(g, w, f"{path}/{i}")
    elif want is None:
        assert got is None, path
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=path)


def _batch(rng):
    mask = np.ones((CLIPS, TOKENS), np.int32)
    mask[1, 7:] = 0
    return {"images": rng.integers(0, 256, (CLIPS, 5, *FRAME_HW, 3)).astype(np.uint8),
            "token_ids": rng.integers(0, 100, (CLIPS, TOKENS)).astype(np.int32),
            "attn_mask": mask, "lang_mask": np.array([1, 1, 0, 1], np.float32)}


def _draws(key, num_neg):
    """What the JAX step draws from `key`: its crop key, rctraj rectangles and
    permutations (as the port takes them)."""
    perm_key, aug_key, _ = jax.random.split(key, 3)
    rects = np.stack([np.array(jaugment.sample_crop_params(k, *FRAME_HW))
                      for k in jax.random.split(aug_key, CLIPS)])
    perms = {k: torch.from_numpy(np.array(v)).long()
             for k, v in jax_draw_permutations(perm_key, CLIPS, num_neg).items()}
    return aug_key, rects, perms


def _configs(optimizer="adam", lr=1e-4, size=18, image_size=32):
    kw = dict(size=size, hidden_dim=64, langweight=1.0, image_size=image_size,
              optimizer=optimizer, lr=lr)
    return JaxR3MConfig(**kw), R3MConfig(**kw)


def test_npz_encoding_reads_the_same_in_both_packages(tmp_path):
    """Nested dicts and lists, None, an empty dict and an empty list, arrays of several
    dtypes: each package reads the other's file, and both write the same flat keys."""
    tree = {"a": np.arange(3, dtype=np.float32), "none": None, "empty_d": {}, "empty_l": [],
            "nest": [np.ones((2, 2), np.int32), {"c": np.array(7, np.uint32), "d": None},
                     [np.zeros(0)]],
            "key": np.array([1, 2], np.uint32)}
    meta = {"global_step": 3, "config": {"size": 0}}
    port, jaxp = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    ckpt.save_snapshot(port, tree, meta)
    jckpt.save_snapshot(jaxp, tree, meta)
    for reader in (ckpt.load_snapshot, jckpt.load_snapshot):
        for path in (port, jaxp):
            got, got_meta = reader(path)
            _assert_trees_equal(got, tree)
            assert got_meta == meta
    with np.load(port) as a, np.load(jaxp) as b:
        assert sorted(a.files) == sorted(b.files)
    assert ckpt._flatten(tree).keys() == jckpt._flatten(tree).keys()


class _JaxRun:
    """A JAX ResNet-18 run with a frozen BERT: the state after one step, and what its
    second step does."""

    def __init__(self, optimizer, lr):
        self.jcfg, self.cfg = _configs(optimizer, lr)
        self.bert_cfg = JaxBertConfig(**BERT_SMALL)
        self.jbert = distilbert_init(jax.random.PRNGKey(7), self.bert_cfg)
        self.bert = distilbert_from_jax(_np(self.jbert), n_heads=BERT_SMALL["n_heads"])
        step = jtrainer.make_train_step(self.jcfg, self.jbert, donate=False, doaug="rctraj",
                                        bert_cfg=self.bert_cfg)
        self.batch = _batch(np.random.default_rng(RESUME_BATCH_SEED[optimizer]))
        state0 = jtrainer.create_train_state(self.jcfg, jax.random.PRNGKey(0))
        self.state1, _ = step(state0, self.batch)
        self.state2, self.metrics2 = step(self.state1, self.batch)

    def grads1(self, aug_key, perms):
        """The JAX gradients at state 1 for the step-2 draws, canonical layout."""
        mean, std = self.jcfg.norm_stats
        images = jaugment.random_resized_crop_clips(
            aug_key, jnp.asarray(self.batch["images"]), out_size=self.jcfg.image_size,
            mode="rctraj", mean=mean, std=std)
        jperms = {k: jnp.asarray(v.numpy(), jnp.int32) for k, v in perms.items()}

        def loss_fn(params):
            loss, _, _ = jtrainer._encode_and_loss(
                self.jcfg, params, self.state1.batch_stats, self.jbert,
                {**self.batch, "images": images}, jperms, True, True, self.bert_cfg)
            return loss

        grads = jax.jit(jax.grad(loss_fn))(self.state1.params)
        return _canonical(grads, self.state1.batch_stats)[0]


@pytest.mark.parametrize("optimizer,lr", OPTIMIZERS)
def test_jax_snapshot_resumes_in_the_port(tmp_path, optimizer, lr):
    """A JAX state after one step, written by the JAX `save_train_snapshot`, loads into a
    fresh port state of another seed with every leaf equal, moments included; the port's
    next step, with the JAX step's crops and permutations, gives the JAX step's loss,
    gradients and BatchNorm statistics, and moves the parameters as the JAX update does
    (which reads the moments, the step count and, for a schedule, the rate at that
    count)."""
    run = _JaxRun(optimizer, lr)
    jckpt.save_train_snapshot(str(tmp_path), run.state1, run.jcfg)
    state = create_train_state(run.cfg, seed=5, device="cpu")
    state, meta = ckpt.load_train_snapshot(str(tmp_path / "snapshot.npz"), state,
                                           with_meta=True)
    assert state.step == meta["global_step"] == 1
    saved, _ = jckpt.load_snapshot(str(tmp_path / "snapshot.npz"))
    loaded = ckpt.train_tree(state, run.cfg)
    for part in ("params", "batch_stats", "opt_state"):
        _assert_trees_equal(loaded[part], saved[part])

    aug_key, rects, perms = _draws(run.state1.key, run.cfg.num_negatives)
    assert_relu_margin(step_forward(run.cfg, state.model, run.batch, perms, rects, run.bert),
                       RESUME_BATCH_SEED[optimizer])
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    step = make_train_step(run.cfg, run.bert, doaug="rctraj", device="cpu")
    state, metrics = step(state, run.batch, perms=perms, crops=torch.from_numpy(rects))
    np.testing.assert_allclose(float(metrics["full_loss"]), float(run.metrics2["full_loss"]),
                               rtol=RTOL)
    assert state.step == 2

    sd = lambda params, stats: state_dict_from_jax(  # noqa: E731
        params, stats, 18, data_parallel=False)
    params1, stats1 = _canonical(run.state1.params, run.state1.batch_stats)
    params2, stats2 = _canonical(run.state2.params, run.state2.batch_stats)
    want_grads = sd(run.grads1(aug_key, perms), stats1)
    want1, want2 = sd(params1, stats1), sd(params2, stats2)
    named = dict(state.model.named_parameters())
    floor = 1e-4 * np.sqrt(sum(np.sum(want_grads[n].double().numpy() ** 2) for n in named))
    for name, p in named.items():
        w = want_grads[name].double().numpy()
        err = np.linalg.norm(p.grad.double().numpy() - w) / max(np.linalg.norm(w), floor)
        assert err <= GRAD_REL_L2, f"{name}: gradient relative L2 error {err}"
    got_u = np.concatenate([(p.detach() - before[n]).double().numpy().ravel()
                            for n, p in named.items()])
    want_u = np.concatenate([(want2[n] - want1[n]).double().numpy().ravel() for n in named])
    err = np.linalg.norm(got_u - want_u) / np.linalg.norm(want_u)
    assert err <= UPDATE_REL_L2, f"update relative L2 error {err}"
    for name, buf in state.model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), want2[name].numpy(), rtol=RTOL, atol=1e-6,
                                       err_msg=name)


# The resumed step's update of all parameters against the JAX update. Adam divides by the
# root of the second moment, so an element whose gradient is rounding noise (the reward
# head's biases, whose InfoNCE gradients cancel) moves its update by a good part of a
# step; over all parameters the updates agree to this, where a lost moment, step count or
# scheduled rate moves them by 10% or more.
UPDATE_REL_L2 = 1e-3


@pytest.mark.parametrize("optimizer,lr", OPTIMIZERS)
def test_port_snapshot_loads_in_jax(tmp_path, optimizer, lr):
    """A port state after one step, written by the port's `save_train_snapshot`, loads in
    the JAX `load_train_snapshot` (into a packed-BatchNorm Adam state too) with params,
    batch stats and every optimizer leaf equal to the port's."""
    jcfg, cfg = _configs(optimizer, lr)
    torch.manual_seed(0)
    state = create_train_state(cfg, seed=3, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"images": rng.integers(0, 256, (CLIPS, 5, 32, 32, 3), np.uint8)}
    step = make_train_step(dataclasses.replace(cfg, langweight=0.0), doaug="none",
                           device="cpu")
    state.model.lang_rew.requires_grad_(False)  # no language: its moments stay zero
    state, _ = step(state, batch)
    ckpt.save_train_snapshot(str(tmp_path), state, cfg)
    assert sorted(os.listdir(tmp_path)) == ["snapshot.npz", "snapshot_1.npz"]

    jstate = jtrainer.create_train_state(jcfg, jax.random.PRNGKey(1))
    jstate, meta = jckpt.load_train_snapshot(str(tmp_path / "snapshot.npz"), jstate,
                                             with_meta=True)
    assert int(jstate.step) == meta["global_step"] == 1
    assert meta["config"] == dataclasses.asdict(cfg)
    got = jckpt.canonicalize_train_tree(
        {"params": jstate.params, "batch_stats": jstate.batch_stats,
         "opt_state": jstate.opt_state})
    want = ckpt.train_tree(state, cfg)
    _assert_trees_equal(_np(got["params"]), want["params"])
    _assert_trees_equal(_np(got["batch_stats"]), want["batch_stats"])
    _assert_trees_equal(jax.tree_util.tree_leaves(_np(got["opt_state"])),
                        jax.tree_util.tree_leaves(want["opt_state"]))
    np.testing.assert_array_equal(np.asarray(jstate.key), want["key"])
    if optimizer == "adam":  # the moments are real: a step's worth of gradient
        assert np.abs(want["opt_state"][0][1]["convnet"]["conv1"]["w"]).max() > 0


def test_port_resume_continues_the_same_draws(tmp_path):
    """Port -> port: parameters, statistics, moments and the generator's state carry over,
    so the resumed state draws what the saved one would have drawn."""
    _, cfg = _configs()
    state = create_train_state(cfg, seed=4, device="cpu")
    torch.rand(5, generator=state.generator)
    state.step = 7
    ckpt.save_train_snapshot(str(tmp_path), state, cfg, keep_step_copy=False)
    assert os.listdir(tmp_path) == ["snapshot.npz"]
    resumed = ckpt.load_train_snapshot(str(tmp_path / "snapshot.npz"),
                                       create_train_state(cfg, seed=9, device="cpu"))
    assert resumed.step == 7
    for (n, a), b in zip(state.model.state_dict().items(), resumed.model.state_dict().values()):
        if "num_batches" not in n:
            assert torch.equal(a, b), n
    assert torch.equal(torch.rand(5, generator=state.generator),
                       torch.rand(5, generator=resumed.generator))


def test_jax_snapshot_reseeds_the_generator_from_its_key(tmp_path):
    jcfg, cfg = _configs()
    jstate = jtrainer.create_train_state(jcfg, jax.random.PRNGKey(2))
    jckpt.save_train_snapshot(str(tmp_path), jstate, jcfg)
    draws = []
    for seed in (0, 1):
        state = ckpt.load_train_snapshot(str(tmp_path / "snapshot.npz"),
                                         create_train_state(cfg, seed=seed, device="cpu"))
        draws.append(torch.rand(4, generator=state.generator))
    assert torch.equal(*draws)
    key = np.asarray(jstate.key, np.uint64)
    want = torch.Generator().manual_seed(int(key[0]) << 32 | int(key[1]))
    assert torch.equal(draws[0], torch.rand(4, generator=want))


def test_snapshot_of_another_architecture_raises_with_the_leaf(tmp_path):
    jcfg, _ = _configs()
    jckpt.save_train_snapshot(str(tmp_path), jtrainer.create_train_state(
        jcfg, jax.random.PRNGKey(0)), jcfg)
    _, other = _configs(size=34)
    with pytest.raises(ValueError, match="layer1.*shape mismatch|snapshot has no leaf"):
        ckpt.load_train_snapshot(str(tmp_path / "snapshot.npz"),
                                 create_train_state(other, device="cpu"))
    _, other = _configs()
    other = dataclasses.replace(other, hidden_dim=32)
    with pytest.raises(ValueError, match="lang_rew.pred.0.weight: .*shape mismatch|"
                                         "shape mismatch at lang_rew.pred.0.weight"):
        ckpt.load_train_snapshot(str(tmp_path / "snapshot.npz"),
                                 create_train_state(other, device="cpu"))


@pytest.mark.parametrize("size,image_size", [(0, 64), (18, 32)])
def test_snapshot_serves_the_jax_embeddings(tmp_path, size, image_size):
    """A JAX-written snapshot (its language head dropped on load) serves in the port, by
    `load_r3m_from_snapshot` and `load_r3m_from_files`, with the JAX package's
    embeddings, in parity precision."""
    jcfg, _ = _configs(size=size, image_size=image_size)
    jstate = jtrainer.create_train_state(jcfg, jax.random.PRNGKey(5))
    if size:  # BatchNorm statistics other than 0 and 1, so the fold does real work
        rng = np.random.default_rng(1)
        stats = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.uniform(0.5, 1.5, x.shape), x.dtype),
            jstate.batch_stats)
        jstate = jstate._replace(batch_stats=stats)
    jckpt.save_train_snapshot(str(tmp_path), jstate, jcfg)
    path = str(tmp_path / "snapshot.npz")
    obs = np.random.default_rng(2).integers(0, 256, (3, 3, image_size + 8, image_size + 8),
                                            dtype=np.uint8)
    want = np.asarray(jax_load_r3m_from_snapshot(path)(obs))
    for load in (load_r3m_from_snapshot, load_r3m_from_files):
        enc = load(path, device="cpu")
        assert enc.cfg.langweight == 0 and enc.cfg.image_size == image_size
        np.testing.assert_allclose(enc(obs).numpy(), want, rtol=1e-4, atol=1e-5)


def test_snapshot_without_config_does_not_serve(tmp_path):
    path = str(tmp_path / "bare.npz")
    ckpt.save_snapshot(path, {"params": {"convnet": {}}}, {"global_step": 1})
    with pytest.raises(ValueError, match="no 'config'"):
        load_r3m_from_snapshot(path, device="cpu")


def test_torch_snapshots_cross_between_the_packages(tmp_path):
    """Port export -> JAX `import_torch_snapshot_to_state`, and JAX `export_torch_snapshot`
    -> port import: weights and statistics equal, the step carried, the optimizer fresh."""
    jcfg, cfg = _configs()
    state = create_train_state(cfg, seed=6, device="cpu")
    with torch.no_grad():
        for name, buf in state.model.named_buffers():
            if name.endswith("running_var"):
                buf.uniform_(0.5, 1.5)
    state.step = 11
    port_pt = ckpt.export_torch_snapshot(str(tmp_path / "port.pt"), state)
    jstate = jckpt.import_torch_snapshot_to_state(
        port_pt, jtrainer.create_train_state(jcfg, jax.random.PRNGKey(0)))
    assert int(jstate.step) == 11
    params, stats = _canonical(jstate.params, jstate.batch_stats)
    want = ckpt.train_tree(state, cfg)
    _assert_trees_equal(params, want["params"])
    _assert_trees_equal(stats, want["batch_stats"])

    jstate = jtrainer.create_train_state(jcfg, jax.random.PRNGKey(8))._replace(
        step=jnp.asarray(4, jnp.int32))
    jax_pt = jckpt.export_torch_snapshot(str(tmp_path / "jax.pt"), jstate, size=18)
    state.optimizer.state[next(state.model.parameters())]["exp_avg"] = torch.ones(1)
    state = ckpt.import_torch_snapshot_to_state(jax_pt, state)
    assert state.step == 4 and not state.optimizer.state
    params, stats = _canonical(jstate.params, jstate.batch_stats)
    want = state_dict_from_jax(params, stats, 18, data_parallel=False)
    for name, x in state.model.state_dict().items():
        if "num_batches" not in name:
            assert torch.equal(x, want[name]), name


def test_config_from_meta_coerces_stale_levers():
    with pytest.warns(UserWarning, match="remat"):
        cfg = ckpt.r3m_config_from_meta({"config": {"size": 0, "remat": "conv_saved",
                                                    "unknown_field": 1}})
    assert cfg.remat == "none" and cfg.size == 0
    with pytest.warns(UserWarning, match="vit_fused_attn"):
        cfg = ckpt.r3m_config_from_meta({"config": {"size": 50, "vit_fused_attn": True}})
    assert cfg.vit_fused_attn is False
    cfg = ckpt.r3m_config_from_meta({"config": {"size": 18, "lr": 0.5}}, langweight=0)
    assert (cfg.size, cfg.lr, cfg.langweight) == (18, 0.5, 0)
    assert cfg == R3MConfig(**{k: v for k, v in dataclasses.asdict(
        jckpt.r3m_config_from_meta({"config": {"size": 18, "lr": 0.5}},
                                   langweight=0)).items()})


def test_step_snapshots_newest_first_ignoring_other_names(tmp_path):
    for name in ("snapshot_5.npz", "snapshot_40.npz", "snapshot_best.npz", "snapshot.npz",
                 "snapshot_7.npz.tmp"):
        (tmp_path / name).write_bytes(b"")
    got = ckpt.step_snapshots(str(tmp_path))
    assert [s for s, _ in got] == [40, 5]
    assert got == jckpt.step_snapshots(str(tmp_path))


def test_async_writer_overlaps_and_surfaces_failures(tmp_path):
    _, cfg = _configs()
    state = create_train_state(cfg, seed=1, device="cpu")
    writer = ckpt.AsyncSnapshotWriter()
    path = ckpt.save_train_snapshot(str(tmp_path), state, cfg, writer=writer)
    with torch.no_grad():  # the host copy was taken before the call returned
        next(state.model.parameters()).add_(1.0)
    writer.wait()
    tree, _ = ckpt.load_snapshot(path)
    np.testing.assert_array_equal(tree["params"]["convnet"]["conv1"]["w"],
                                  ckpt.train_tree(create_train_state(cfg, seed=1, device="cpu"))
                                  ["params"]["convnet"]["conv1"]["w"])
    writer.submit(lambda: 1 / 0)
    with pytest.raises(RuntimeError, match="async snapshot write failed"):
        writer.wait()
