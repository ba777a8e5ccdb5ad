"""The port's command-line tools against the JAX package's, on the CPU (``--device cpu``).

- embed: the same PNG files through both CLIs give the same ``paths`` and embeddings to
  atol 1e-4; file collection, the padded tail batch and the exit code as in the JAX tests;
- convert: ``to-native`` writes the JAX CLI's ``params`` / ``batch_stats`` exactly (a
  ResNet-18 with its reward head, a ViT at 64 px), ``to-torch`` the JAX CLI's state dict
  tensor for tensor, and a round trip gives back every tensor;
- prepare_language: on a tiny local HF directory, the ``.npz`` arrays, the metadata and
  ``vocab.txt`` equal the JAX command's;
- verify_parity: ok on a round-tripped artifact, as the JAX CLI reports it; its exit
  codes, a detected weight divergence, a ViT artifact, the language path (also when the
  vision reference falls back) and convert-only mode on ``.npz``.
"""

import dataclasses
import json
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml

import jax

from r3m_tpu import checkpoint as jckpt
from r3m_tpu import convert as jconvert
from r3m_tpu import embed as jembed
from r3m_tpu import verify_parity as jverify
from r3m_tpu.models.r3m import R3MConfig as JaxR3MConfig, r3m_init as jax_r3m_init
from r3m_tpu.training.trainer import create_train_state as jax_create_train_state
from r3m_tpu_torch import convert, embed, verify_parity
from r3m_tpu_torch.checkpoint import load_snapshot

from .torch_ref import TorchLanguageReward, torch_resnet

EMBED_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _remove_tmp_path(tmp_path):
    """Each test's temporary directory goes when the test ends: the suite's files add up."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _jax_snapshot(path, seed=0, **cfg_kw):
    """A native snapshot of a fresh JAX state's weights (canonical BatchNorm), config in
    its metadata: what serving and ``to-torch`` read, without the optimizer moments."""
    cfg = JaxR3MConfig(**cfg_kw)
    state = jax_create_train_state(cfg, jax.random.PRNGKey(seed))
    tree = jckpt.canonicalize_train_tree({"params": state.params,
                                          "batch_stats": state.batch_stats})
    jckpt.save_snapshot(str(path), jax.tree_util.tree_map(np.asarray, tree),
                        {"config": dataclasses.asdict(cfg), "global_step": 3})
    return str(path)


def _assert_trees_equal(got, want):
    jax.tree_util.tree_map(np.testing.assert_array_equal, got, want)


# ---------------------------------------------------------------------------------------
# embed


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    """Nine PNG files of three sizes in two directories."""
    image = pytest.importorskip("PIL.Image")
    root = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(0)
    for i in range(9):
        sub = root / f"video{i % 2}"
        sub.mkdir(exist_ok=True)
        h, w = ((40, 52), (32, 32), (64, 48))[i % 3]
        pixels = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        image.fromarray(pixels).save(sub / f"frame{i:02d}.png")
    yield str(root)
    shutil.rmtree(root, ignore_errors=True)


@pytest.fixture(scope="module")
def r18_snapshot(tmp_path_factory):
    d = tmp_path_factory.mktemp("r18")
    yield _jax_snapshot(d / "snap.npz", size=18, image_size=32)
    shutil.rmtree(d, ignore_errors=True)


def test_images_load_as_the_jax_loader_loads_them(image_dir):
    files = embed.collect_image_files([image_dir])
    assert files == jembed.collect_image_files([image_dir]) and len(files) == 9
    got = embed._load_images(files, 32)
    assert got.dtype == np.uint8 and got.shape == (9, 3, 32, 32)
    np.testing.assert_array_equal(got, jembed._load_images(files, 32))


@pytest.mark.parametrize("precision", ["parity", "fast"])
def test_embed_cli_matches_jax(image_dir, r18_snapshot, tmp_path, precision):
    """Batches of 4 over 9 files: two full batches and a padded tail of one."""
    args = [image_dir, "--snapshot", r18_snapshot, "--batch", "4", "--precision", precision]
    want = np.load(jembed.main(args + ["--out", str(tmp_path / "jax.npz")]))
    out = embed.main(args + ["--out", str(tmp_path / "port.npz"), "--device", "cpu"])
    got = np.load(out)
    assert list(got["paths"]) == list(want["paths"]) == sorted(got["paths"])
    assert got["embeddings"].dtype == np.float32 and got["embeddings"].shape == (9, 512)
    # fast: both packages run bf16, each in its own order
    atol = EMBED_ATOL if precision == "parity" else 5e-2
    np.testing.assert_allclose(got["embeddings"], want["embeddings"], rtol=0, atol=atol)
    if precision == "parity":  # the padding does not leak into a batch's rows
        one = np.load(embed.main([str(got["paths"][-1]), "--snapshot", r18_snapshot,
                                  "--out", str(tmp_path / "one.npz"), "--device", "cpu"]))
        np.testing.assert_allclose(one["embeddings"][0], got["embeddings"][-1], atol=2e-5)


def test_embed_cli_from_a_reference_model_file(image_dir, tmp_path):
    model = torch_resnet(18).eval()
    pt = str(tmp_path / "model.pt")
    torch.save({"r3m": {f"module.convnet.{k}": v for k, v in model.state_dict().items()}}, pt)
    args = [image_dir, "--model-file", pt, "--batch", "8"]
    want = np.load(jembed.main(args + ["--out", str(tmp_path / "jax.npz")]))
    got = np.load(embed.main(args + ["--out", str(tmp_path / "port.npz"), "--device", "cpu"]))
    assert list(got["paths"]) == list(want["paths"])
    np.testing.assert_allclose(got["embeddings"], want["embeddings"], rtol=0, atol=EMBED_ATOL)


def test_collect_image_files_rejects_junk(tmp_path):
    (tmp_path / "x.txt").write_text("nope")
    with pytest.raises(ValueError, match="not an image"):
        embed.collect_image_files([str(tmp_path / "x.txt")])
    with pytest.raises(ValueError, match="no image files"):
        embed.collect_image_files([str(tmp_path)])


def test_collect_image_files_dedups_overlapping_inputs(tmp_path):
    d = tmp_path / "imgs"
    d.mkdir()
    (d / "a.jpg").write_bytes(b"x")
    (d / "b.JPEG").write_bytes(b"x")
    inputs = [str(d), str(d / "a.jpg"), str(d)]
    files = embed.collect_image_files(inputs)
    assert files == jembed.collect_image_files(inputs) == sorted(files) and len(files) == 2


def test_cli_returns_zero_and_n_devices_waits(monkeypatch, tmp_path):
    """``--n-devices N`` builds a mesh of the first N cards, which waits for a card: with
    none it raises before it loads anything (``tests/test_torch_parallel_workspace.py``
    runs it on the CPU)."""
    monkeypatch.setattr(embed, "main", lambda argv=None: "/some/path.npz")
    assert embed.cli([]) == 0
    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "a.png").write_bytes(b"x")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        embed.main([str(tmp_path), "--out", str(tmp_path / "e.npz"), "--n-devices", "2"])


def test_embed_cli_raises_without_a_card(r18_snapshot, image_dir, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        embed.main([image_dir, "--snapshot", r18_snapshot, "--out", str(tmp_path / "e.npz")])


# ---------------------------------------------------------------------------------------
# convert


@pytest.fixture(scope="module")
def reference_snapshots(tmp_path_factory):
    """Reference-format ``snapshot.pt`` files: a ResNet-18 with its reward head (at the
    default head width, which both CLIs' template states use) at step 7, and a ViT at
    64 px without one."""
    d = tmp_path_factory.mktemp("ref_pt")
    out = {}
    for name, size, kw in (("r18", 18, dict(langweight=1.0, image_size=32)),
                           ("vit", 0, dict(image_size=64))):
        cfg = JaxR3MConfig(size=size, **kw)
        state = jax_create_train_state(cfg, jax.random.PRNGKey(size + 1))
        path = str(d / f"{name}.pt")
        jckpt.export_torch_snapshot(
            path, SimpleNamespace(params=state.params, batch_stats=state.batch_stats,
                                  step=np.int32(7)), size=size)
        out[name] = path
    yield out
    shutil.rmtree(d, ignore_errors=True)


@pytest.mark.parametrize("which", ["r18", "vit"])
def test_to_native_matches_jax(reference_snapshots, tmp_path, which):
    src, out = reference_snapshots[which], str(tmp_path / "out.npz")

    def written():  # read, then delete: a ViT-B/32 train snapshot is over 1 GB
        tree, meta = load_snapshot(out)
        os.remove(out)
        return tree, meta

    jconvert.main(["to-native", src, out])
    want, want_meta = written()
    assert convert.main(["to-native", src, out, "--device", "cpu"]) == 0
    got, got_meta = written()
    for group in ("params", "batch_stats"):
        _assert_trees_equal(got[group], want[group])
    assert got_meta == want_meta and got_meta["global_step"] == 7
    # a fresh optimizer, as the JAX CLI's: count 0, zero moments
    assert int(got["opt_state"][0][0]) == int(want["opt_state"][0][0]) == 0
    _assert_trees_equal(got["opt_state"][0][1], want["opt_state"][0][1])


@pytest.mark.parametrize("lang", [False, True])
def test_to_torch_matches_jax_and_round_trips(tmp_path, lang):
    snap = _jax_snapshot(tmp_path / "s.npz", size=18, image_size=32,
                         langweight=1.0 if lang else 0.0, hidden_dim=64)
    jconvert.main(["to-torch", snap, str(tmp_path / "jax.pt")])
    assert convert.main(["to-torch", snap, str(tmp_path / "port.pt"), "--device", "cpu"]) == 0
    got, want = (torch.load(str(tmp_path / f"{n}.pt"), weights_only=True) for n in ("port", "jax"))
    assert got["global_step"] == want["global_step"]
    assert set(got["r3m"]) == set(want["r3m"])
    assert any("lang_rew" in k for k in got["r3m"]) == lang
    for k, v in want["r3m"].items():
        assert got["r3m"][k].dtype == v.dtype and torch.equal(got["r3m"][k], v), k
    # and back: every convnet and lang_rew tensor as it was
    convert.main(["to-native", str(tmp_path / "port.pt"), str(tmp_path / "back.npz"),
                  "--device", "cpu"])
    back, meta = load_snapshot(str(tmp_path / "back.npz"))
    assert meta["config"]["hidden_dim"] == (64 if lang else 1024)  # the head's own width
    orig, _ = load_snapshot(snap)
    for group in ("params", "batch_stats"):
        _assert_trees_equal(back[group], orig[group])


def test_convert_raises_without_a_card(reference_snapshots, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.main(["to-native", reference_snapshots["vit"], str(tmp_path / "x.npz")])


# ---------------------------------------------------------------------------------------
# prepare_language

VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "the", "robot", "##s", "open", "door"]


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    transformers = pytest.importorskip("transformers")
    d = tmp_path_factory.mktemp("hf_distilbert")
    torch.manual_seed(0)
    transformers.DistilBertModel(transformers.DistilBertConfig(
        vocab_size=len(VOCAB), dim=32, n_layers=2, n_heads=4, hidden_dim=64,
        max_position_embeddings=16)).save_pretrained(str(d))
    vocab_file = str(d / "src_vocab.txt")
    with open(vocab_file, "w") as f:
        f.write("\n".join(VOCAB) + "\n")
    transformers.DistilBertTokenizer(vocab_file=vocab_file).save_pretrained(str(d))
    yield str(d)
    shutil.rmtree(d, ignore_errors=True)


def test_prepare_language_matches_jax(hf_dir, tmp_path, capsys):
    from r3m_tpu.prepare_language import prepare as jax_prepare
    from r3m_tpu_torch.models.distilbert import load_bert
    from r3m_tpu_torch.prepare_language import main

    jax_prepare(hf_dir, str(tmp_path / "jax"))
    main(["--model", hf_dir, "--out", str(tmp_path / "port")])
    assert "wrote" in capsys.readouterr().out
    with np.load(str(tmp_path / "port" / "distilbert.npz")) as got, np.load(
            str(tmp_path / "jax" / "distilbert.npz")) as want:
        assert set(got.files) == set(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for name in ("vocab.txt",):
        assert ((tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
                == "\n".join(VOCAB) + "\n")
    bert = load_bert(str(tmp_path / "port" / "distilbert.npz"), device="cpu")
    assert (bert.cfg.dim, bert.cfg.n_layers, bert.cfg.n_heads) == (32, 2, 4)


# ---------------------------------------------------------------------------------------
# verify_parity


@pytest.fixture(scope="module")
def vp_artifacts(tmp_path_factory):
    """A reference ResNet-18 ``model.pt`` (BN statistics perturbed, a stray reward-head
    key) and its training config with an interpolation."""
    d = tmp_path_factory.mktemp("vp")
    torch.manual_seed(0)
    model = torch_resnet(18).eval()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.2, 0.2)
                m.running_var.uniform_(0.8, 1.2)
    sd = {f"module.convnet.{k}": v for k, v in model.state_dict().items()}
    sd["module.lang_rew.pred.0.weight"] = torch.zeros(8, 8)
    modelpath = str(d / "model.pt")
    torch.save({"r3m": sd}, modelpath)
    configpath = str(d / "config.yaml")
    with open(configpath, "w") as f:
        yaml.safe_dump({"lr": 1e-4, "agent": {"lr": "${lr}", "size": 18}}, f)
    yield modelpath, configpath
    shutil.rmtree(d, ignore_errors=True)


def _language_artifact(path):
    """A ResNet-18 artifact with the whole language stack: an HF DistilBertModel under
    ``lang_enc.model.`` and the reference's reward MLP under ``lang_rew.``."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(1)
    hf = transformers.DistilBertModel(transformers.DistilBertConfig(
        vocab_size=30, dim=48, n_layers=1, n_heads=12, hidden_dim=48,
        max_position_embeddings=32)).eval()
    head = TorchLanguageReward(512, 16, 48).eval()
    sd = {f"module.convnet.{k}": v for k, v in torch_resnet(18).state_dict().items()}
    sd.update({f"module.lang_enc.model.{k}": v for k, v in hf.state_dict().items()})
    sd.update({f"module.lang_rew.{k}": v for k, v in head.state_dict().items()})
    torch.save({"r3m": sd}, path)
    return path


def test_verify_parity_passes_on_a_round_trip_as_jax_reports_it(vp_artifacts):
    modelpath, configpath = vp_artifacts
    got = verify_parity.verify_parity(modelpath, configpath, n_images=3, device="cpu")
    want = jverify.verify_parity(modelpath, configpath, n_images=3)
    assert set(want) <= set(got)
    for k in ("mode", "size", "out_dim", "images", "bar", "ok"):
        assert got[k] == want[k], k
    assert got["mode"] == "torch-reference" and got["ok"] is True
    assert got["cosine_min"] >= verify_parity.COSINE_BAR and got["device"] == "cpu"


def test_verify_parity_cli_exit_codes(vp_artifacts, capsys, monkeypatch):
    modelpath, configpath = vp_artifacts
    assert verify_parity.main([modelpath, configpath, "--images", "2", "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out.strip())["ok"] is True
    # a reference that disagrees: cosine -1, exit 1
    real = verify_parity._torch_forward
    monkeypatch.setattr(verify_parity, "_torch_forward", lambda sd, im: -real(sd, im))
    assert verify_parity.main([modelpath, "--images", "2", "--device", "cpu"]) == 1
    out = json.loads(capsys.readouterr().out.strip())
    assert out["ok"] is False and out["cosine_min"] < -0.99


def test_verify_parity_detects_weight_divergence(vp_artifacts, tmp_path):
    """Each artifact agrees with its own torch reference, and a perturbed conv changes
    the embeddings."""
    import r3m_tpu_torch

    modelpath, configpath = vp_artifacts
    payload = torch.load(modelpath, map_location="cpu", weights_only=True)
    bad = dict(payload["r3m"])
    k = "module.convnet.layer1.0.conv1.weight"
    bad[k] = bad[k] + torch.randn(bad[k].shape, generator=torch.Generator().manual_seed(0)) * 0.5
    badpath = str(tmp_path / "model.pt")
    torch.save({"r3m": bad}, badpath)
    result = verify_parity.verify_parity(badpath, configpath, n_images=2, device="cpu")
    assert result["mode"] == "torch-reference" and result["ok"] is True
    images = np.random.default_rng(0).uniform(0, 255, (2, 3, 224, 224)).astype(np.float32)
    good_e, bad_e = (r3m_tpu_torch.load_r3m_from_files(p, configpath, device="cpu")(images)
                     for p in (modelpath, badpath))
    assert (good_e - bad_e).abs().max().item() > 1e-2


def test_verify_parity_on_native_snapshots_and_other_sizes_is_convert_only(tmp_path,
                                                                          vp_artifacts):
    cfg = JaxR3MConfig(size=18, langweight=0.0)
    state = jax_r3m_init(jax.random.PRNGKey(0), cfg)
    path = str(tmp_path / "snapshot.npz")
    jckpt.save_snapshot(path, {"params": state["params"], "batch_stats": state["batch_stats"]},
                        meta={"config": {"size": 18}})
    got = verify_parity.verify_parity(path, None, n_images=2, device="cpu")
    want = jverify.verify_parity(path, None, n_images=2)
    assert got["mode"] == want["mode"] == "convert-only" and got["ok"] is want["ok"] is True
    modelpath, configpath = vp_artifacts
    other = verify_parity.verify_parity(modelpath, configpath, n_images=2, image_size=64,
                                        device="cpu")
    assert other["mode"] == "convert-only" and other["ok"] is True


def test_verify_parity_vit_artifact(tmp_path):
    """A ViT artifact runs the torch-reference comparison against HF ``ViTModel``."""
    pytest.importorskip("transformers")
    cfg = JaxR3MConfig(size=0, langweight=0.0, image_size=64)
    state = jax_r3m_init(jax.random.PRNGKey(1), cfg)
    modelpath = str(tmp_path / "model.pt")
    jckpt.export_torch_snapshot(modelpath, SimpleNamespace(
        params=state["params"], batch_stats=state["batch_stats"], step=np.int32(0)), size=0)
    result = verify_parity.verify_parity(modelpath, None, n_images=2, device="cpu")
    assert result["mode"] == "torch-reference", result
    assert (result["size"], result["out_dim"]) == (0, 768)
    assert result["cosine_min"] >= verify_parity.COSINE_BAR and result["ok"] is True


@pytest.mark.parametrize("vision_reference", [True, False])
def test_verify_parity_language_path(tmp_path, monkeypatch, vision_reference):
    """The language stack is compared with HF DistilBertModel and the reference MLP, also
    when the vision reference falls back to convert-only."""
    modelpath = _language_artifact(str(tmp_path / "model.pt"))
    if not vision_reference:
        monkeypatch.setattr(verify_parity, "_torch_forward", lambda *a, **kw: None)
    result = verify_parity.verify_parity(modelpath, None, n_images=2, device="cpu")
    assert result["mode"] == ("torch-reference" if vision_reference else "convert-only")
    assert result["lang_ok"] is True and result["lang_max_abs_diff"] < 1e-4, result
    assert result["ok"] is True
    if vision_reference:
        want = jverify.verify_parity(modelpath, None, n_images=2)
        assert want["lang_ok"] is True
        assert abs(result["lang_max_abs_diff"] - want["lang_max_abs_diff"]) < 1e-4


def test_verify_parity_raises_without_a_card(vp_artifacts, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        verify_parity.main([vp_artifacts[0]])
