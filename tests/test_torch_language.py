"""The port's language stack against the JAX package's, on the CPU.

The WordPiece tokenizer (ids and masks equal, int32, both padding modes, on the JAX
tokenizer tests' sentences and a seeded fuzz), the DistilBERT loaders (`load_bert` from a
JAX-format ``.npz`` with and without ``bert_config`` metadata and from an HF state dict,
plain and ``distilbert.``-prefixed: sentence embeddings to atol 1e-5 against the JAX
``sentence_embedding``), the language half of checkpoint conversion, `pad_batch` and the
package's exports.
"""

import dataclasses
import shutil

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax

import r3m_tpu
import r3m_tpu_torch
from r3m_tpu.checkpoint import load_torch_checkpoint as jax_load_torch_checkpoint
from r3m_tpu.checkpoint import save_snapshot as jax_save_snapshot
from r3m_tpu.convert import convert_language_stack as jax_convert_language_stack
from r3m_tpu.models import distilbert as jbert
from r3m_tpu.text.tokenizer import WordPieceTokenizer as JaxTokenizer
from r3m_tpu.text.tokenizer import load_vocab as jax_load_vocab
from r3m_tpu.training.workspace import load_bert_params
from r3m_tpu.utils.misc import pad_batch as jax_pad_batch
from r3m_tpu_torch.checkpoint import load_torch_checkpoint
from r3m_tpu_torch.convert import (
    convert_language_stack,
    distilbert_state_from_jax,
    distilbert_tree,
    remove_language_head,
)
from r3m_tpu_torch.models.distilbert import (
    DistilBertConfig,
    config_from_params,
    distilbert_config_from_state,
    load_bert,
    sentence_embedding,
)
from r3m_tpu_torch.text.tokenizer import WordPieceTokenizer, load_vocab
from r3m_tpu_torch.utils.misc import pad_batch

from .test_tokenizer import SENTENCES, VOCAB_TOKENS

# The small DistilBERT of these tests; 4 heads, which no shape shows. A second one of 12
# heads stands in where the loader must assume 12 (no metadata, or an HF state dict).
BERT = dict(vocab_size=40, dim=64, n_layers=2, n_heads=4, hidden_dim=96,
            max_position_embeddings=24)
BERT12 = dict(BERT, dim=48, n_heads=12)
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _remove_tmp_path(tmp_path):
    """Each test's temporary directory goes when the test ends: the suite's files add up."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _vocab_file(path, tokens):
    path.write_text("\n".join(dict.fromkeys(tokens)) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def vocab_file(tmp_path_factory):
    return _vocab_file(tmp_path_factory.mktemp("vocab") / "vocab.txt", VOCAB_TOKENS)


@pytest.mark.parametrize("sentence", SENTENCES)
def test_tokenizer_matches_jax(vocab_file, sentence):
    ours, want = WordPieceTokenizer(vocab_file=vocab_file), JaxTokenizer(vocab_file=vocab_file)
    assert ours.basic_tokenize(sentence) == want.basic_tokenize(sentence)
    assert ours.tokenize(sentence) == want.tokenize(sentence)
    assert ours.encode(sentence) == want.encode(sentence)
    assert ours.encode(sentence, max_len=4) == want.encode(sentence, max_len=4)


@pytest.mark.parametrize("max_len", [None, 16, 5])
def test_encode_batch_matches_jax_in_both_padding_modes(vocab_file, max_len):
    ours, want = WordPieceTokenizer(vocab_file=vocab_file), JaxTokenizer(vocab_file=vocab_file)
    assert load_vocab(vocab_file) == jax_load_vocab(vocab_file)
    batch = SENTENCES + ["the " * 20]
    for (got, ref) in zip(ours.encode_batch(batch, max_len), want.encode_batch(batch, max_len)):
        assert got.dtype == ref.dtype == np.int32
        np.testing.assert_array_equal(got, ref)


_FUZZ_TOKENS = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + list("abcdeist")
                + [f"##{c}" for c in "abcdeist"] + ["the", "##ing", "知", ",", "."])
_FUZZ_ALPHABET = "abcdeistABCDE éàüñÅçİı知道,.!-'\t\n　\x01�😀²½"


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(st.lists(st.text(alphabet=_FUZZ_ALPHABET, max_size=30), min_size=1, max_size=4),
       st.sampled_from([None, 6, 12]))
def test_tokenizer_fuzz_matches_jax(tmp_path_factory, texts, max_len):
    path = tmp_path_factory.getbasetemp() / "fuzz_vocab.txt"
    if not path.exists():
        _vocab_file(path, _FUZZ_TOKENS)
    ours, want = WordPieceTokenizer(vocab_file=str(path)), JaxTokenizer(vocab_file=str(path))
    for got, ref in zip(ours.encode_batch(texts, max_len), want.encode_batch(texts, max_len)):
        np.testing.assert_array_equal(got, ref)


def _jax_bert(cfg_kw, seed=1):
    cfg = jbert.DistilBertConfig(**cfg_kw)
    params = jbert.distilbert_init(jax.random.PRNGKey(seed), cfg)
    return jax.tree_util.tree_map(np.asarray, params), cfg


def _tokens(seed=0, b=3, t=10, vocab=40):
    """Ids and a mask with one sentence shorter than the pad length and one full row."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, t)).astype(np.int32)
    mask = np.ones((b, t), np.int32)
    mask[0, 4:] = 0
    mask[2, 7:] = 0
    return ids * mask, mask


def _port_embedding(model, ids, mask):
    return sentence_embedding(model, torch.from_numpy(ids), torch.from_numpy(mask)).numpy()


@pytest.mark.parametrize("source", ["npz_bert_config", "npz_shapes", "hf", "hf_prefixed"])
def test_load_bert_matches_jax(tmp_path, source):
    """`load_bert` and the JAX ``load_bert_params`` read the same file: the same
    architecture and sentence embeddings to atol 1e-5, padded rows included. With
    ``bert_config`` metadata the 4 heads come from it; without, both assume 12. An HF
    state dict is a tiny `transformers.DistilBertModel`'s (``DistilBertFor*`` saves carry
    it under ``distilbert.``), and its own mean-pooled output agrees too."""
    ids, mask = _tokens()
    cfg_kw = BERT if source == "npz_bert_config" else BERT12
    hf_want = None
    if source.startswith("npz"):
        params, jcfg = _jax_bert(cfg_kw)
        path = str(tmp_path / "distilbert.npz")
        meta = {"bert_config": dataclasses.asdict(jcfg)} if source == "npz_bert_config" else {}
        jax_save_snapshot(path, params, meta)
    else:
        transformers = pytest.importorskip("transformers")
        torch.manual_seed(0)
        hf = transformers.DistilBertModel(transformers.DistilBertConfig(**cfg_kw)).eval()
        with torch.no_grad():
            hf_want = hf(torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(
                mask).long()).last_hidden_state.mean(1).numpy()
        sd = hf.state_dict()
        if source == "hf_prefixed":  # a DistilBertFor* save
            sd = {f"distilbert.{k}": v for k, v in sd.items()}
            sd["pre_classifier.weight"] = torch.zeros(2, 2)
        path = str(tmp_path / "distilbert.pt")
        torch.save(sd, path)
    want_params, want_cfg = load_bert_params(path)
    model = load_bert(path, device="cpu")
    assert dataclasses.asdict(model.cfg) == dataclasses.asdict(want_cfg)
    assert model.cfg.n_heads == cfg_kw["n_heads"]
    assert not any(p.requires_grad for p in model.parameters()) and not model.training
    got = _port_embedding(model, ids, mask)
    want = np.asarray(jbert.sentence_embedding(want_params, ids, mask, want_cfg))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    if hf_want is not None:
        np.testing.assert_allclose(got, hf_want, rtol=0, atol=ATOL)


def test_load_bert_refuses_a_state_dict_it_cannot_fill(tmp_path):
    params, _ = _jax_bert(BERT12)
    sd = distilbert_state_from_jax(params)
    del sd["transformer.layer.1.ffn.lin2.bias"]
    path = str(tmp_path / "distilbert.pt")
    torch.save(sd, path)
    with pytest.raises(ValueError, match="lacks"):
        load_bert(path, device="cpu")


def test_load_bert_raises_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_bert(str(tmp_path / "distilbert.npz"))


def test_bert_configs_and_trees_match_jax():
    params, _ = _jax_bert(BERT)
    sd = distilbert_state_from_jax(params)
    for n_heads in (4, 12):
        assert (dataclasses.asdict(config_from_params(params, n_heads))
                == dataclasses.asdict(jbert.config_from_params(params, n_heads)))
        assert (dataclasses.asdict(distilbert_config_from_state(sd, n_heads))
                == dataclasses.asdict(jbert.distilbert_config_from_state(sd, n_heads)))
    prefixed = {f"distilbert.{k}": v for k, v in sd.items()}
    assert distilbert_config_from_state(prefixed) == DistilBertConfig(**dict(BERT, n_heads=12))
    with pytest.raises(ValueError, match="transformer.layer"):
        distilbert_config_from_state({k: v for k, v in sd.items()
                                      if not k.startswith("transformer.")})
    got = distilbert_tree(prefixed)
    want = jbert.convert_distilbert(sd, jbert.distilbert_config_from_state(sd))
    jax.tree_util.tree_map(np.testing.assert_array_equal, got, want)


@pytest.fixture(scope="module")
def language_snapshot_pt(tmp_path_factory):
    """A reference-format snapshot.pt of a small ResNet-18 R3M with its reward head and an
    embedded 12-head DistilBERT (``module.lang_enc.model.*``), at global step 11."""
    from r3m_tpu_torch.models.r3m import R3MConfig, r3m_init

    params, _ = _jax_bert(BERT12)
    model = r3m_init(R3MConfig(size=18, hidden_dim=32, langweight=1.0, lang_dim=48), 0)
    sd = {f"module.{k}": v for k, v in model.state_dict().items()}
    sd.update({f"module.lang_enc.model.{k}": v
               for k, v in distilbert_state_from_jax(params).items()})
    d = tmp_path_factory.mktemp("lang_pt")
    path = str(d / "snapshot.pt")
    torch.save({"r3m": sd, "global_step": 11}, path)
    yield path, sd
    shutil.rmtree(d, ignore_errors=True)


def test_convert_language_stack_matches_jax(language_snapshot_pt):
    _, sd = language_snapshot_pt
    stripped = {k[len("module."):]: v for k, v in sd.items()}
    got, want = convert_language_stack(stripped), jax_convert_language_stack(stripped)
    for i, layer in enumerate(want["lang_rew"]["layers"]):
        np.testing.assert_array_equal(got["lang_rew"][f"pred.{2 * i}.weight"].numpy().T,
                                      layer["w"])
        np.testing.assert_array_equal(got["lang_rew"][f"pred.{2 * i}.bias"].numpy(), layer["b"])
    assert dataclasses.asdict(got["lang_enc"]["cfg"]) == dataclasses.asdict(
        want["lang_enc"]["cfg"])
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           distilbert_tree(got["lang_enc"]["state"]), want["lang_enc"]["params"])
    # a partly stripped head, or none at all, is no head; no lang_enc keys, no encoder
    partial = {k: v for k, v in stripped.items() if k != "lang_rew.pred.8.bias"}
    bare = remove_language_head(stripped)
    assert bare == r3m_tpu.remove_language_head(stripped)
    assert not any("lang" in k for k in bare)
    for sd_ in (partial, bare):
        got, want = convert_language_stack(sd_), jax_convert_language_stack(sd_)
        assert got["lang_rew"] is None and want["lang_rew"] is None
    assert convert_language_stack(bare)["lang_enc"] is None


@pytest.mark.parametrize("include_language", [False, True])
def test_load_torch_checkpoint_matches_jax(language_snapshot_pt, include_language):
    path, _ = language_snapshot_pt
    got = load_torch_checkpoint(path, include_language=include_language)
    want = jax_load_torch_checkpoint(path, include_language=include_language)
    assert (got["size"], got["global_step"]) == (want["size"], want["global_step"]) == (18, 11)
    assert got["image_size"] is None and "image_size" not in want
    assert (got["lang_rew"] is None) == (want["lang_rew"] is None) == (not include_language)
    assert (got["lang_enc"] is None) == (want["lang_enc"] is None)
    np.testing.assert_array_equal(got["convnet"]["conv1.weight"].numpy().transpose(2, 3, 1, 0),
                                  want["convnet"]["params"]["conv1"]["w"])
    np.testing.assert_array_equal(got["convnet"]["layer4.1.bn2.running_var"].numpy(),
                                  want["convnet"]["batch_stats"]["layer4"][1]["bn2"]["var"])


@pytest.mark.parametrize("m,n", [(3, 5), (5, 5), (6, 4), (1, 3)])
def test_pad_batch_matches_jax(m, n):
    arr = np.arange(m * 2 * 3, dtype=np.float32).reshape(m, 2, 3)
    got, want = pad_batch(arr, n), jax_pad_batch(arr, n)
    assert got.shape == (max(m, n), 2, 3)
    np.testing.assert_array_equal(got, want)


def test_package_exports_what_the_jax_package_exports():
    """Every name of the JAX package's ``__all__`` resolves in the port, `R3MRewardModel`
    and `bc_probe` on first use; an unknown name raises AttributeError."""
    missing = set(r3m_tpu.__all__) - set(r3m_tpu_torch.__all__)
    assert missing == set()
    for name in r3m_tpu_torch.__all__:
        assert getattr(r3m_tpu_torch, name) is not None, name
    from r3m_tpu_torch.evalsuite.bc import bc_probe
    from r3m_tpu_torch.reward import R3MRewardModel

    assert r3m_tpu_torch.R3MRewardModel is R3MRewardModel
    assert r3m_tpu_torch.bc_probe is bc_probe
    with pytest.raises(AttributeError):
        r3m_tpu_torch.not_a_name  # noqa: B018
