"""The port's Ego4D input stack against the JAX package's, on the CPU.

The same manifest, alpha and seed give both packages' `Ego4DDataset` the same stream of
frame paths and captions, draw for draw (`skip_batches` and host shards included); each
package reads the manifest the other wrote; the port's decoders give the JAX package's
frames bit for bit (native against native: the port builds the repo's
``csrc/jpeg_decoder.cpp`` itself, into ``r3m_tpu_torch/build/``; PIL against PIL), failed
files included; `DataPipeline` batch dicts are equal. The port's stream fingerprint is the
same on every host and after the dataset moves, and changes with the seed, alpha or a
``len``.
"""

import os
import shutil

import numpy as np
import pandas as pd
import pytest
from PIL import Image

from r3m_tpu.data import decoder as jdecoder
from r3m_tpu.data import ego4d as jego4d
from r3m_tpu.data.pipeline import DataPipeline as JaxDataPipeline
from r3m_tpu.text.tokenizer import WordPieceTokenizer as JaxTokenizer
from r3m_tpu_torch.data import decoder, ego4d
from r3m_tpu_torch.data.pipeline import DataPipeline
from r3m_tpu_torch.ops import _build
from r3m_tpu_torch.text.tokenizer import WordPieceTokenizer

STREAM_BATCHES = 60
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "opens", "the", "door", "picks", "up", "a",
         "cup", "person", "moves", "object", ",", "0", "1", "2", "3"]


@pytest.fixture(autouse=True)
def _remove_tmp_path(tmp_path):
    """Each test's temporary directory goes when the test ends: the suite's files add up."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """Six videos of 64 px frames, with the JAX package's writer."""
    d = tmp_path_factory.mktemp("ego4d_port")
    yield jego4d.write_synthetic_dataset(
        str(d), n_videos=6, min_len=10, max_len=20,
        size=64, captions=["C opens the door", "C picks up a cup", ""])
    shutil.rmtree(d, ignore_errors=True)


@pytest.fixture(scope="module")
def manifest(root, tmp_path_factory):
    """A hand-written manifest over the fixture's folders: ``len`` as ``12`` and ``12.0``,
    an empty and a missing (``NA``) caption, a quoted caption with a comma, a blank
    line and no final newline."""
    rows = pd.read_csv(os.path.join(root, "manifest.csv"))
    p = [str(x) for x in rows["path"]]
    n = [int(x) for x in rows["len"]]
    text = ("path,len,txt\n"
            f"{p[0]},{n[0]},C opens the door\n"
            f"{p[1]},{n[1]}.0,\n"
            f'{p[2]},{n[2]},"C picks up a cup, then a door"\n'
            "\n"
            f"{p[3]},{n[3]},NA\n"
            f"{p[4]},{float(n[4])},C \n"
            f"{p[5]},{n[5]},C moves object 3")
    path = tmp_path_factory.mktemp("manifest") / "manifest.csv"
    path.write_text(text)
    yield str(path)
    shutil.rmtree(path.parent, ignore_errors=True)


def _datasets(manifest_path, **kw):
    jax_rows = pd.read_csv(manifest_path)
    port_rows = ego4d.read_manifest(manifest_path)
    return (jego4d.Ego4DDataset("", manifest=jax_rows, **kw),
            ego4d.Ego4DDataset("", manifest=port_rows, **kw))


@pytest.mark.parametrize("alpha,seed,shard", [
    (0.2, 0, (0, 1)), (0.0, 1, (0, 1)), (0.5, 7, (0, 1)), (0.2, 3, (1, 2)), (0.2, 4, (2, 3)),
])
def test_sample_stream_equals_jax(manifest, alpha, seed, shard):
    """Paths and captions over 60 batches of 4 clips; then both skip 7 batches and go on."""
    j, p = _datasets(manifest, alpha=alpha, seed=seed, shard_index=shard[0],
                     num_shards=shard[1])
    assert len(j) == len(p)
    captions = set()
    for _ in range(STREAM_BATCHES):
        jb, pb = j.sample_batch(4), p.sample_batch(4)
        assert pb == jb
        captions.update(pb[1])
    j.skip_batches(7, 4)
    p.skip_batches(7, 4)
    for _ in range(5):
        assert p.sample_batch(4) == j.sample_batch(4)
    if shard[1] == 1:  # the empty, missing and quoted captions were all drawn
        assert {"", "picks up a cup, then a door", "moves object 3"} <= captions


def test_short_rows_and_bad_shards_are_refused_alike(manifest, tmp_path):
    rows = ego4d.read_manifest(manifest)
    rows[2] = {**rows[2], "len": 2}
    short = tmp_path / "short.csv"
    ego4d.write_manifest(str(short), rows)
    for ds, read in ((jego4d.Ego4DDataset, pd.read_csv),
                     (ego4d.Ego4DDataset, ego4d.read_manifest)):
        with pytest.raises(ValueError, match="len < 3"):
            ds("", manifest=read(str(short)), num_shards=2)
        with pytest.raises(ValueError, match="num_shards"):
            ds("", manifest=read(manifest), num_shards=7)


def test_each_package_reads_the_manifest_the_other_wrote(root, tmp_path):
    """The JAX writer's manifest (pandas) read by the port, and the port's writer (csv)
    read by pandas: the same rows, and the same dataset bytes from the same arguments."""
    port_root = ego4d.write_synthetic_dataset(
        str(tmp_path / "port"), n_videos=6, min_len=10, max_len=20, size=64,
        captions=["C opens the door", "C picks up a cup", ""])
    jax_root = jego4d.write_synthetic_dataset(
        str(tmp_path / "jax"), n_videos=6, min_len=10, max_len=20, size=64,
        captions=["C opens the door", "C picks up a cup", ""])
    for writer_root in (port_root, jax_root):
        port = ego4d.read_manifest(os.path.join(writer_root, "manifest.csv"))
        frame = pd.read_csv(os.path.join(writer_root, "manifest.csv"))
        assert [r["path"] for r in port] == list(frame["path"])
        assert [r["len"] for r in port] == list(frame["len"])
        assert [r["txt"] for r in port] == list(frame["txt"])
    with open(os.path.join(port_root, "manifest.csv")) as a, \
            open(os.path.join(jax_root, "manifest.csv")) as b:
        assert a.read().replace(port_root, "ROOT") == b.read().replace(jax_root, "ROOT")
    with open(os.path.join(port_root, "vid003", "000007.jpg"), "rb") as a, \
            open(os.path.join(jax_root, "vid003", "000007.jpg"), "rb") as b:
        assert a.read() == b.read()
    j, p = (jego4d.Ego4DDataset(jax_root, seed=5), ego4d.Ego4DDataset(port_root, seed=5))
    for _ in range(10):
        jp, jc = j.sample_batch(3)
        pp, pc = p.sample_batch(3)
        assert pc == jc and [x.replace(port_root, jax_root) for x in pp] == jp


@pytest.fixture(scope="module")
def frames(root, tmp_path_factory):
    """Paths of 224 px, 256 px and 64 px JPEGs and of a missing, a garbage, a header-only
    and a cut-off file."""
    d = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(0)
    paths = []
    for i, size in enumerate((224, 224, 256, 256, 64)):
        p = d / f"f{i}.jpg"
        Image.fromarray(rng.integers(0, 256, (size, size + 8 * i, 3), np.uint8)).save(
            p, quality=90)
        paths.append(str(p))
    good = open(paths[2], "rb").read()
    (d / "garbage.jpg").write_bytes(b"\xff\xd8\xff\xe0" + b"\x00" * 256)
    (d / "header.jpg").write_bytes(good[:120])
    (d / "cut.jpg").write_bytes(good[: int(len(good) * 0.6)])
    bad = [str(d / "missing.jpg"), str(d / "garbage.jpg"), str(d / "header.jpg"),
           str(d / "cut.jpg")]
    fixture = [os.path.join(root, "vid000", f"{t:06}.jpg") for t in range(1, 9)]
    yield paths + bad + fixture
    shutil.rmtree(d, ignore_errors=True)


@pytest.fixture
def failures(monkeypatch):
    """The (failed, n) counts each package's decoder reports."""
    seen = {"jax": [], "port": []}
    monkeypatch.setattr(jdecoder, "_warn_failed", lambda f, n: seen["jax"].append((f, n)))
    monkeypatch.setattr(decoder, "_warn_failed", lambda f, n: seen["port"].append((f, n)))
    return seen


@pytest.mark.parametrize("hw", [(224, 224), (64, 96)])
@pytest.mark.parametrize("route", ["native", "pil"])
def test_decoders_equal_jax_bit_for_bit(frames, failures, route, hw):
    port = decoder.JpegDecoder(*hw, n_threads=3)
    jax = jdecoder.JpegDecoder(*hw, n_threads=3)
    if route == "native":
        assert port.native and jax.native
        got, want = port.decode_batch(frames), jax.decode_batch(frames)
    else:
        out = np.empty((len(frames), *hw, 3), np.uint8)
        got = port._decode_batch_pil(frames, out.copy())
        want = jax._decode_batch_pil(frames, out.copy())
    np.testing.assert_array_equal(got, want)
    assert failures["port"] == failures["jax"] == [(4, len(frames))]
    assert not got[5:9].any() and got[:5].any()


def test_decode_buffer_is_checked(frames):
    dec = decoder.JpegDecoder(64, 64, n_threads=1)
    with pytest.raises(ValueError, match="uint8"):
        dec.decode_batch(frames[:2], np.empty((2, 64, 64, 3), np.float32))
    with pytest.raises(ValueError, match="uint8"):
        dec.decode_batch(frames[:2], np.empty((3, 64, 64, 3), np.uint8))
    with pytest.raises(ValueError, match="C-contiguous"):
        dec.decode_batch(frames[:2], np.empty((2, 64, 128, 3), np.uint8)[:, :, ::2])


def test_native_pipeline_equals_jax(root):
    j = jdecoder.NativeFramePipeline(jego4d.Ego4DDataset(root, seed=3), 3, height=64,
                                     width=80, n_threads=2, depth=2)
    p = decoder.NativeFramePipeline(ego4d.Ego4DDataset(root, seed=3), 3, height=64,
                                    width=80, n_threads=2, depth=2)
    batcher = ego4d.FrameBatcher(ego4d.Ego4DDataset(root, seed=3), 3, height=64, width=80)
    try:
        for _ in range(4):
            (jc, jcap), (pc, pcap) = j.next_batch(), p.next_batch()
            bc, bcap = batcher.next_batch()
            assert pc.shape == (3, 5, 64, 80, 3) and pcap == jcap == bcap
            np.testing.assert_array_equal(pc, jc)
            np.testing.assert_array_equal(bc, jc)
    finally:
        j.close()
        p.close()
    p.close()  # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        p.next_batch()
    with pytest.raises(ValueError, match="invalid pipeline dims"):
        decoder.NativeFramePipeline(ego4d.Ego4DDataset(root, seed=3), 0, height=64, width=64)


def test_data_pipeline_batches_equal_jax(root, tmp_path):
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(VOCAB) + "\n")
    jpipe = JaxDataPipeline(jego4d.FrameBatcher(jego4d.Ego4DDataset(root, seed=2), 4, 64, 64),
                            tokenizer=JaxTokenizer(vocab_file=str(vocab)), lang_max_len=8)
    ppipe = DataPipeline(ego4d.FrameBatcher(ego4d.Ego4DDataset(root, seed=2), 4, 64, 64),
                         tokenizer=WordPieceTokenizer(vocab_file=str(vocab)), lang_max_len=8)
    try:
        for _ in range(3):
            jb, pb = next(jpipe), next(ppipe)
            assert set(pb) == set(jb) == {"images", "captions", "token_ids", "attn_mask",
                                          "lang_mask"}
            assert pb["captions"] == jb["captions"]
            for k in ("images", "token_ids", "attn_mask", "lang_mask"):
                assert pb[k].dtype == jb[k].dtype, k
                np.testing.assert_array_equal(pb[k], jb[k], err_msg=k)
        assert pb["token_ids"].dtype == np.int32 and pb["lang_mask"].dtype == np.float32
    finally:
        jpipe.close()
        ppipe.close()


def test_decoder_library_is_the_ports_own_build():
    lib = decoder.JpegDecoder(8, 8)._lib
    assert decoder.decoder_status() == ("native", "")
    assert os.path.dirname(lib._name) == _build.BUILD_DIR
    assert lib._name == _build.decoder_library_path()
    assert os.path.basename(lib._name).startswith("libr3m_decoder-")
    assert os.path.abspath(jdecoder._LIB_PATH) != lib._name
    assert "r3m_tpu/" not in lib._name.replace("r3m_tpu_torch/", "")


def test_stream_fingerprint_follows_the_draws_not_the_paths(root, tmp_path):
    moved = tmp_path / "moved"
    shutil.copytree(root, moved)
    rows = ego4d.read_manifest(os.path.join(root, "manifest.csv"))
    for r in rows:
        r["path"] = r["path"].replace(root, str(moved))
    ego4d.write_manifest(str(moved / "manifest.csv"), rows)

    def fp(path=root, **kw):
        return ego4d.Ego4DDataset(str(path), **{"seed": 1, **kw}).stream_fingerprint()

    base = fp()
    assert fp(moved) == base
    # every host of a job: seed base + i, rows i::n
    assert fp(seed=2, shard_index=1, num_shards=2) == base
    assert fp(seed=2) != base
    assert fp(alpha=0.3) != base
    rows[4]["len"] += 1
    ego4d.write_manifest(str(moved / "manifest.csv"), rows)
    assert fp(moved) != base
