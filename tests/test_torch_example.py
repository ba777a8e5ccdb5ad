"""``python -m r3m_tpu_torch.example`` on the CPU, against the JAX package.

The example imports neither JAX nor the JAX package; offline (no cached weights, the fetch
failing at once, so nothing is downloaded or waited on) it says so and encodes with a
random-init ResNet-50, and with a populated ``$R3M_HOME`` it loads the cached weights.
Its random-init encoder's embedding of a fixed image equals the JAX `R3MEncoder`'s on the
same weights, to the serving tolerance of ``tests/test_torch_serving.py``.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import r3m_tpu
from r3m_tpu_torch import example, fetch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _remove_tmp_path(tmp_path):
    """Each test's temporary directory goes when the test ends: the suite's files add up."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture
def offline(tmp_path, monkeypatch):
    """An empty ``$R3M_HOME`` and a fetch that fails at once."""
    def no_network(file_id, dest):
        raise OSError("offline")

    monkeypatch.setenv("R3M_HOME", str(tmp_path / "r3m_home"))
    monkeypatch.setattr(fetch, "_drive_download", no_network)
    return tmp_path / "r3m_home"


def _model_pt(path, convnet):
    """A reference-format ``model.pt`` of `convnet`'s weights."""
    torch.save({"r3m": {f"module.convnet.{k}": v for k, v in convnet.state_dict().items()}},
               path)
    return str(path)


def _cosine_rows(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def test_example_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, r3m_tpu_torch.example\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'r3m_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr


def test_example_falls_back_to_random_init_offline(offline, capsys):
    assert example.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("pretrained weights unavailable") and "not cached" in out[0]
    assert out[0].endswith("using random init")
    assert out[-1] == "[1, 2048]"


def test_example_loads_cached_weights(offline, capsys):
    """With ``model.pt`` and ``config.yaml`` in ``$R3M_HOME/r3m_50``, nothing is fetched."""
    home = offline / "r3m_50"
    home.mkdir(parents=True)
    _model_pt(home / "model.pt", example.random_init_encoder("cpu").convnet)
    (home / "config.yaml").write_text("agent:\n  size: 50\n  langweight: 1.0\n")
    assert example.main(["--device", "cpu"]) == 0
    assert capsys.readouterr().out.splitlines() == ["loaded pretrained resnet50", "[1, 2048]"]


def test_example_needs_the_card_it_asks_for(offline, monkeypatch):
    """The default device is the card; without one the example raises before it loads
    anything, and does not fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        example.main([])
    assert not offline.exists()


def test_random_init_embedding_matches_jax(tmp_path):
    enc = example.random_init_encoder("cpu")
    assert enc.cfg.size == 50 and enc.cfg.langweight == 0 and enc.outdim == 2048
    path = _model_pt(tmp_path / "model.pt", enc.convnet)
    image = np.random.default_rng(0).integers(0, 256, (500, 500, 3), dtype=np.uint8)
    obs = image.transpose(2, 0, 1)[None]
    got = enc(obs).numpy()
    want = np.asarray(r3m_tpu.load_r3m_from_files(path)(obs.astype(np.float32)))
    assert got.shape == want.shape == (1, 2048) and np.isfinite(got).all()
    assert np.all(_cosine_rows(got, want) > 0.9999)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    again = example.random_init_encoder("cpu")  # seed 0: the same weights each time
    assert all(torch.equal(a, b) for a, b in zip(enc.convnet.state_dict().values(),
                                                 again.convnet.state_dict().values()))
