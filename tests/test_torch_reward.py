"""The port's `R3MRewardModel` against the JAX package's, on the CPU.

One seeded language-trained ResNet-18 at 32 px (a JAX snapshot of its weights), a ViT at
64 px and a ResNet-18 with an embedded DistilBERT (reference-format ``snapshot.pt``
files), a small DistilBERT (2 layers, dim 64, 4 heads, written with ``bert_config``
metadata) and a vocab: `get_reward`, `__call__` (equal and unequal image shapes), `reward_curve`, both
padding modes and ``lang_max_len`` from the metadata agree with
``r3m_tpu.reward.R3MRewardModel`` to rtol 1e-4 / atol 1e-5 in parity precision; fast
precision stays within atol 0.05 of parity.
"""

import dataclasses
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

from r3m_tpu import checkpoint as jckpt
from r3m_tpu.models import distilbert as jbert
from r3m_tpu.models.r3m import R3MConfig as JaxR3MConfig
from r3m_tpu.reward import R3MRewardModel as JaxRewardModel
from r3m_tpu.training.trainer import create_train_state as jax_create_train_state
from r3m_tpu_torch.convert import distilbert_state_from_jax
from r3m_tpu_torch.reward import R3MRewardModel

VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "the", "pick", "up", "cup", "door", "open",
         "drawer", "##s", "robot"]
BERT = dict(vocab_size=len(VOCAB), dim=64, n_layers=2, n_heads=4, hidden_dim=96,
            max_position_embeddings=40)
# An embedded DistilBERT is read with 12 heads (nothing in a state dict says otherwise).
BERT12 = dict(BERT, dim=48, n_heads=12)
SENTENCES = ["pick up the cup", "open the drawers slowly", "robot"]
RTOL, ATOL = 1e-4, 1e-5
FAST_ATOL = 0.05


def _jax_state(seed, **cfg_kw):
    cfg = JaxR3MConfig(**{"langweight": 1.0, "hidden_dim": 32, **cfg_kw})
    return cfg, jax_create_train_state(cfg, jax.random.PRNGKey(seed))


def _weights_snapshot(path, cfg, state, **meta):
    """A native snapshot of a JAX state's weights (canonical BatchNorm), config in its
    metadata: what serving reads, without the optimizer moments a train snapshot carries."""
    tree = jckpt.canonicalize_train_tree({"params": state.params,
                                          "batch_stats": state.batch_stats})
    jckpt.save_snapshot(path, jax.tree_util.tree_map(np.asarray, tree),
                        {"config": dataclasses.asdict(cfg), **meta})
    return path


def _export_pt(path, state, size, extra=None):
    """A reference-format ``snapshot.pt`` of a JAX state, plus `extra` entries."""
    jckpt.export_torch_snapshot(
        path, SimpleNamespace(params=state.params, batch_stats=state.batch_stats,
                              step=state.step), size=size)
    if extra:
        payload = torch.load(path, map_location="cpu", weights_only=True)
        payload["r3m"].update(extra)
        torch.save(payload, path)
    return path


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("reward"))
    cfg, state = _jax_state(0, size=18, image_size=32, lang_dim=BERT["dim"])
    snap = _weights_snapshot(os.path.join(d, "snap.npz"), cfg, state)
    snap16 = _weights_snapshot(os.path.join(d, "snap16.npz"), cfg, state, lang_max_len=16)
    no_head = _weights_snapshot(os.path.join(d, "no_head.npz"),
                                *_jax_state(0, size=18, image_size=32, langweight=0.0))

    bcfg = jbert.DistilBertConfig(**BERT)
    bert = os.path.join(d, "distilbert.npz")
    jckpt.save_snapshot(bert, jbert.distilbert_init(jax.random.PRNGKey(1), bcfg),
                        {"bert_config": dataclasses.asdict(bcfg)})
    vocab = os.path.join(d, "vocab.txt")
    with open(vocab, "w") as f:
        f.write("\n".join(VOCAB) + "\n")

    _, vit = _jax_state(2, size=0, image_size=64, lang_dim=BERT["dim"])
    vit_pt = _export_pt(os.path.join(d, "vit.pt"), vit, 0)
    bert12 = jax.tree_util.tree_map(np.asarray, jbert.distilbert_init(
        jax.random.PRNGKey(3), jbert.DistilBertConfig(**BERT12)))
    _, r18 = _jax_state(4, size=18, image_size=32, lang_dim=BERT12["dim"])
    embedded = {f"module.lang_enc.model.{k}": v
                for k, v in distilbert_state_from_jax(bert12).items()}
    embedded_pt = _export_pt(os.path.join(d, "embedded.pt"), r18, 18, embedded)
    bare_pt = _export_pt(os.path.join(d, "bare.pt"), r18, 18)
    yield SimpleNamespace(snap=snap, snap16=snap16, no_head=no_head, bert=bert, vocab=vocab,
                          vit_pt=vit_pt, embedded_pt=embedded_pt, bare_pt=bare_pt)
    shutil.rmtree(d, ignore_errors=True)


@pytest.fixture(scope="module")
def jax_models(art):
    """The JAX reward models of the tests, each built once."""
    built = {}

    def get(key):
        if key not in built:
            kind, arg = key
            if kind == "snapshot":
                built[key] = JaxRewardModel.from_snapshot(art.snap, art.bert, art.vocab,
                                                          pad_mode=arg)
            elif kind == "snap16":
                built[key] = JaxRewardModel.from_snapshot(art.snap16, art.bert, art.vocab)
            else:
                built[key] = JaxRewardModel.from_torch_snapshot(arg, None if kind == "embedded"
                                                                else art.bert, art.vocab)
        return built[key]

    return get


def _close(got, want):
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def _images(seed, n=3, hw=(32, 32)):
    return np.random.default_rng(seed).integers(0, 256, (n, 3, *hw), dtype=np.uint8)


def _embeddings(seed, n=3, d=512):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, d)).astype(np.float32), rng.standard_normal(
        (n, d)).astype(np.float32)


@pytest.mark.parametrize("pad_mode", ["fixed", "longest"])
def test_get_reward_matches_jax(art, jax_models, pad_mode):
    rm = R3MRewardModel.from_snapshot(art.snap, art.bert, art.vocab, pad_mode=pad_mode,
                                      device="cpu")
    assert (rm.cfg.size, rm.lang_max_len, rm.pad_mode) == (18, 32, pad_mode)
    e0, es = _embeddings(0)
    _close(rm.get_reward(e0, es, SENTENCES), jax_models(("snapshot", pad_mode)).get_reward(
        e0, es, SENTENCES))
    # the instruction reaches the head
    other = rm.get_reward(e0, es, ["open the door"] * 3)
    assert not torch.allclose(other, rm.get_reward(e0, es, SENTENCES))


def test_padding_changes_the_reward_and_lang_max_len_comes_from_the_metadata(art, jax_models):
    e0, es = _embeddings(1, n=1)
    fixed = R3MRewardModel.from_snapshot(art.snap, art.bert, art.vocab, device="cpu")
    longest = R3MRewardModel.from_snapshot(art.snap, art.bert, art.vocab, pad_mode="longest",
                                           device="cpu")
    sentence = ["pick up the cup"]
    assert not torch.allclose(fixed.get_reward(e0, es, sentence),
                              longest.get_reward(e0, es, sentence))
    n_tok = len(longest.tokenizer.encode(sentence[0]))
    exact = R3MRewardModel.from_snapshot(art.snap, art.bert, art.vocab, lang_max_len=n_tok,
                                         device="cpu")
    torch.testing.assert_close(exact.get_reward(e0, es, sentence),
                               longest.get_reward(e0, es, sentence), rtol=1e-6, atol=0)
    rm16 = R3MRewardModel.from_snapshot(art.snap16, art.bert, art.vocab, device="cpu")
    assert rm16.lang_max_len == 16
    e0, es = _embeddings(2)
    _close(rm16.get_reward(e0, es, SENTENCES),
           jax_models(("snap16", None)).get_reward(e0, es, SENTENCES))


@pytest.mark.parametrize("shapes", ["equal", "unequal"])
def test_images_reward_matches_jax(art, jax_models, monkeypatch, shapes):
    """Start and current frames of one shape go through the encoder as one stacked pass;
    of two shapes (the second resized and cropped), as two."""
    rm = R3MRewardModel.from_snapshot(art.snap, art.bert, art.vocab, device="cpu")
    im0 = _images(3)
    imt = _images(4, hw=(32, 32) if shapes == "equal" else (40, 48))
    calls = []
    encoder = rm._encoder
    monkeypatch.setattr(rm, "_encoder", lambda x: calls.append(x.shape[0]) or encoder(x))
    got = rm(im0, imt, SENTENCES)
    assert calls == ([6] if shapes == "equal" else [3, 3])
    want = jax_models(("snapshot", "fixed"))(im0.astype(np.float32), imt.astype(np.float32),
                                             SENTENCES)
    _close(got, want)


def test_reward_curve_matches_jax(art, jax_models):
    rm = R3MRewardModel.from_snapshot(art.snap, art.bert, art.vocab, device="cpu")
    frames = _images(5, n=6)
    curve = rm.reward_curve(frames, "open the door")
    assert curve.shape == (6,)
    _close(curve, jax_models(("snapshot", "fixed")).reward_curve(frames.astype(np.float32),
                                                                 "open the door"))
    e0 = rm.embed(frames[:1])
    torch.testing.assert_close(curve[:1], rm.get_reward(e0, e0, ["open the door"]),
                               rtol=1e-5, atol=0)


def test_fast_precision_stays_near_parity(art):
    parity = R3MRewardModel.from_snapshot(art.snap, art.bert, art.vocab, device="cpu")
    fast = R3MRewardModel.from_snapshot(art.snap, art.bert, art.vocab, precision="fast",
                                        device="cpu")
    assert fast._encoder.precision == "fast"
    im0, imt = _images(6), _images(7)
    r, rf = parity(im0, imt, SENTENCES), fast(im0, imt, SENTENCES)
    assert rf.dtype == torch.float32 and torch.isfinite(rf).all()
    np.testing.assert_allclose(rf.numpy(), r.numpy(), atol=FAST_ATOL)


def test_vit_reward_from_a_reference_snapshot_matches_jax(art, jax_models):
    """A ViT's crop size (64 px) comes from its position table."""
    rm = R3MRewardModel.from_torch_snapshot(art.vit_pt, art.bert, art.vocab, device="cpu")
    assert (rm.cfg.size, rm.cfg.image_size, rm.pad_mode) == (0, 64, "longest")
    im0, imt = _images(8, n=2, hw=(64, 64)), _images(9, n=2, hw=(64, 64))
    want = jax_models(("torch", art.vit_pt))(im0.astype(np.float32), imt.astype(np.float32),
                                             SENTENCES[:2])
    _close(rm(im0, imt, SENTENCES[:2]), want)


def test_reward_from_an_embedded_distilbert_matches_jax(art, jax_models):
    """``bert_weights=None`` serves from the ``lang_enc.model.*`` the snapshot embeds."""
    rm = R3MRewardModel.from_torch_snapshot(art.embedded_pt, None, art.vocab, device="cpu")
    assert rm.bert.cfg.dim == BERT12["dim"] and rm.bert.cfg.n_layers == BERT12["n_layers"]
    e0, es = _embeddings(10)
    _close(rm.get_reward(e0, es, SENTENCES),
           jax_models(("embedded", art.embedded_pt)).get_reward(e0, es, SENTENCES))


def test_missing_head_or_distilbert_raises(art):
    with pytest.raises(ValueError, match="language head"):
        R3MRewardModel.from_snapshot(art.no_head, art.bert, art.vocab, device="cpu")
    with pytest.raises(ValueError, match="lang_enc"):
        R3MRewardModel.from_torch_snapshot(art.bare_pt, None, art.vocab, device="cpu")
    with pytest.raises(ValueError, match="pad_mode"):
        R3MRewardModel.from_snapshot(art.snap, art.bert, art.vocab, pad_mode="max",
                                     device="cpu")
    pt = os.path.join(os.path.dirname(art.bare_pt), "headless.pt")
    payload = torch.load(art.bare_pt, map_location="cpu", weights_only=True)
    payload["r3m"] = {k: v for k, v in payload["r3m"].items() if "lang_rew" not in k}
    torch.save(payload, pt)
    with pytest.raises(ValueError, match="language-reward head"):
        R3MRewardModel.from_torch_snapshot(pt, art.bert, art.vocab, device="cpu")


def test_entry_points_raise_without_a_card(art, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: R3MRewardModel.from_snapshot(art.snap, art.bert, art.vocab),
                  lambda: R3MRewardModel.from_torch_snapshot(art.vit_pt, None, art.vocab)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()


def test_language_and_head_run_in_true_f32_whatever_the_callers_flags(art, monkeypatch):
    """DistilBERT and the reward MLP run with TF32 off for cuDNN and matmuls, whatever the
    caller set, and the caller's flags come back after."""
    rm = R3MRewardModel.from_snapshot(art.snap, art.bert, art.vocab, device="cpu")
    seen = []

    def spy(module, args):
        seen.append((type(module).__name__, torch.backends.cudnn.allow_tf32,
                     torch.get_float32_matmul_precision()))

    rm.bert.register_forward_pre_hook(spy)
    rm.lang_rew.register_forward_pre_hook(spy)
    saved = (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("medium")
    try:
        e0, es = _embeddings(11, n=1)
        rm.get_reward(e0, es, ["open the door"])
        rm.reward_curve(_images(12, n=2), "open the door")
        after = (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())
    finally:
        torch.backends.cudnn.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])
    assert seen == [("DistilBert", False, "highest"), ("LanguageReward", False, "highest")] * 2
    assert after == (True, "medium")
