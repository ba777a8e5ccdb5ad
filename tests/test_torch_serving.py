"""The port's serving slice end to end against the JAX package, on the CPU.

One seeded reference-format ``model.pt`` goes through `r3m_tpu.load_r3m_from_files` and
`r3m_tpu_torch.load_r3m_from_files(device="cpu")`; the port also loads from a populated
``R3M_HOME`` cache, refolds after a weight swap, keeps TF32 switched off only while a
parity forward runs, and imports neither JAX nor the JAX package.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

import r3m_tpu
import r3m_tpu_torch
from r3m_tpu.convert import export_r3m_torch_state
from r3m_tpu.models.r3m import R3MConfig as JaxR3MConfig, r3m_init
from r3m_tpu_torch.models.r3m import R3MConfig, R3MEncoder
from r3m_tpu_torch.models.resnet import ResNet


def _cosine_rows(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def _write_model_pt(path, size, seed=0, image_size=64):
    """A reference-format model.pt from JAX weights, BN statistics perturbed."""
    cfg = JaxR3MConfig(size=size, image_size=image_size)
    state = jax.tree_util.tree_map(np.asarray, r3m_init(jax.random.PRNGKey(seed), cfg))
    sd = export_r3m_torch_state(state["params"], state["batch_stats"], size)
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in sd.items():
        if k.endswith("running_mean"):
            v = v + rng.uniform(-0.1, 0.1, v.shape).astype(np.float32)
        elif k.endswith("running_var"):
            v = v * rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        out[k] = torch.tensor(np.asarray(v))
    torch.save({"r3m": out, "global_step": 7}, path)
    return str(path)


@pytest.fixture(scope="module")
def resnet18_pt(tmp_path_factory):
    return _write_model_pt(tmp_path_factory.mktemp("r18") / "model.pt", 18)


@pytest.fixture(scope="module")
def vit_pt(tmp_path_factory):
    return _write_model_pt(tmp_path_factory.mktemp("vit") / "model.pt", 0)


def _frames(rng, hw=(48, 64), n=2):
    return rng.integers(0, 256, size=(n, 3, *hw)).astype(np.uint8)


@pytest.mark.parametrize("which", ["resnet18", "vit"])
def test_load_r3m_from_files_parity_matches_jax(rng, resnet18_pt, vit_pt, which):
    path = resnet18_pt if which == "resnet18" else vit_pt
    # a non-crop-size input runs resize + crop; ViT weights fix a 64 px crop
    obs = _frames(rng, (48, 64) if which == "resnet18" else (40, 90))
    want = np.asarray(r3m_tpu.load_r3m_from_files(path)(obs.astype(np.float32)))
    enc = r3m_tpu_torch.load_r3m_from_files(path, device="cpu")
    got = enc(obs)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert got.shape == want.shape == (2, enc.outdim)
    assert enc.cfg.image_size == (224 if which == "resnet18" else 64)
    assert np.all(_cosine_rows(got.numpy(), want) > 0.9999)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("which", ["resnet18", "vit"])
def test_fast_matches_parity(rng, resnet18_pt, vit_pt, which):
    path = resnet18_pt if which == "resnet18" else vit_pt
    obs = _frames(rng, (64, 64))
    parity = r3m_tpu_torch.load_r3m_from_files(path, device="cpu")(obs).numpy()
    fast = r3m_tpu_torch.load_r3m_from_files(path, precision="fast", device="cpu")(obs)
    assert fast.dtype == torch.float32  # f32 at the API boundary
    assert np.all(_cosine_rows(fast.numpy(), parity) >= 0.995)
    rel = np.abs(np.linalg.norm(fast.numpy(), axis=-1) / np.linalg.norm(parity, axis=-1) - 1)
    assert np.all(rel < 0.05), rel


def test_full_width_vit_fast_path_deviates_from_parity_as_jax_does(tmp_path):
    """ViT-B/32 at full width (224 px, 12 layers of 768), 16 frames, through both
    packages in parity and in fast precision (bf16, the residual stream in bf16). The
    fast path's distance from parity is bf16's, the same in both packages: the port's
    parity equals JAX's (cosine >= 0.99999), the two fast paths agree (>= 0.9998), and
    the port's smallest fast-vs-parity cosine is within 3e-5 of JAX's. Measured on frame
    seeds 0-9 (this test's draw): parity 1.0 to 1e-7 (to 2e-12 at seed 7); fast against
    fast 0.999849 to 0.999879 (0.999857 at seed 7); smallest fast-vs-parity 0.999884 to
    0.999903 in the port and 0.999888 to 0.999912 in JAX (0.999894 and 0.999902 at seed
    7), 4e-6 to 1.8e-5 apart."""
    path = _write_model_pt(tmp_path / "model.pt", 0, image_size=224)
    obs = _frames(np.random.default_rng(7), (224, 224), n=16)
    out = {}
    for precision in ("parity", "fast"):
        out["jax", precision] = np.asarray(
            r3m_tpu.load_r3m_from_files(path, precision=precision)(obs.astype(np.float32)))
        out["port", precision] = r3m_tpu_torch.load_r3m_from_files(
            path, precision=precision, device="cpu")(obs).numpy()
    os.remove(path)  # 350 MB of weights; the suite's temporary files add up
    assert all(e.shape == (16, 768) and np.isfinite(e).all() for e in out.values())
    assert _cosine_rows(out["port", "parity"], out["jax", "parity"]).min() >= 0.99999
    assert _cosine_rows(out["port", "fast"], out["jax", "fast"]).min() >= 0.9998
    fast_vs_parity = {pkg: _cosine_rows(out[pkg, "fast"], out[pkg, "parity"]).min()
                      for pkg in ("port", "jax")}
    assert abs(fast_vs_parity["port"] - fast_vs_parity["jax"]) <= 3e-5, fast_vs_parity


def test_load_r3m_from_cache_matches_jax(rng, resnet18_pt, tmp_path, monkeypatch):
    """`load_r3m("resnet18")` from a populated R3M_HOME reads the cached model.pt and
    the training config (with OmegaConf interpolations) and downloads nothing."""
    home = tmp_path / "r3m_18"
    home.mkdir()
    (home / "model.pt").write_bytes(open(resnet18_pt, "rb").read())
    (home / "config.yaml").write_text(
        "lr: 1e-4\nbatch_size: 16\nagent:\n  _target_: r3m.R3M\n  device: cuda\n"
        "  size: 50\n  lr: ${lr}\n  bs: ${batch_size}\n  hidden_dim: 1024\n"
        "  l2weight: 1e-5\n  langweight: 1.0\n  missing: ${nowhere}\n"
    )
    monkeypatch.setenv("R3M_HOME", str(tmp_path))
    obs = _frames(rng)
    want = np.asarray(r3m_tpu.load_r3m("resnet18")(obs.astype(np.float32)))
    enc = r3m_tpu_torch.load_r3m("resnet18", device="cpu")
    assert (enc.cfg.size, enc.cfg.lr, enc.cfg.bs, enc.cfg.langweight) == (18, 1e-4, 16, 0.0)
    np.testing.assert_allclose(enc(obs).numpy(), want, rtol=1e-3, atol=1e-3)
    with pytest.raises(NameError, match="Invalid Model ID"):
        r3m_tpu_torch.load_r3m("resnet101", device="cpu")


@pytest.mark.parametrize("swap", ["load_state_dict", "module", "param_data"])
def test_encoder_refolds_on_weight_swap(rng, swap):
    cfg = R3MConfig(size=18, image_size=64)
    torch.manual_seed(0)
    enc = R3MEncoder(cfg, device="cpu")
    other = ResNet(18)
    with torch.no_grad():
        for m in other.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_var.uniform_(0.5, 1.5)
    obs = _frames(rng, (64, 64))
    e1 = enc(obs)
    if swap == "load_state_dict":
        enc.convnet.load_state_dict(other.state_dict())  # in place: same tensors
    elif swap == "module":
        enc.convnet = other.eval()
    else:
        enc.convnet.layer4[1].bn2.running_var.data = other.layer4[1].bn2.running_var.clone()
    e2 = enc(obs)
    assert not torch.allclose(e1, e2)
    if swap != "param_data":
        fresh = R3MEncoder(cfg, other.state_dict(), device="cpu")(obs)
        torch.testing.assert_close(e2, fresh)


def test_parity_forward_turns_tf32_off_only_while_it_runs(rng, monkeypatch):
    import r3m_tpu_torch.models.r3m as r3m_mod

    seen = []
    real = r3m_mod.resnet_apply_folded

    def spy(*args, **kw):
        seen.append((torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()))
        return real(*args, **kw)

    monkeypatch.setattr(r3m_mod, "resnet_apply_folded", spy)
    saved = (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("medium")
    try:
        cfg = R3MConfig(size=18, image_size=32)
        obs = _frames(rng, (32, 32))
        R3MEncoder(cfg, device="cpu")(obs)
        R3MEncoder(cfg, precision="fast", device="cpu")(obs)
        after = (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())
    finally:
        torch.backends.cudnn.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])
    assert seen == [(False, "highest"), (True, "medium")]
    assert after == (True, "medium")


def test_entry_points_raise_without_a_card(resnet18_pt, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        r3m_tpu_torch.load_r3m_from_files(resnet18_pt)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        R3MEncoder(R3MConfig(size=18))
    # native snapshots: the device is resolved before the file is read
    with pytest.raises(RuntimeError, match="device='cpu'"):
        r3m_tpu_torch.load_r3m_from_files("snapshot.npz")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        r3m_tpu_torch.load_r3m_from_snapshot("snapshot.npz")


def test_encoder_input_checks(rng):
    enc = R3MEncoder(R3MConfig(size=18, image_size=32), device="cpu")
    assert enc.module is enc and enc.outdim == 512
    assert enc(_frames(rng, (32, 32), n=1)[0]).shape == (1, 512)  # CHW gets a batch
    assert enc(torch.from_numpy(_frames(rng, (32, 32))).float()).shape == (2, 512)
    with pytest.raises(ValueError, match="channels-last"):
        enc(np.zeros((2, 32, 32, 3), np.uint8))
    with pytest.raises(ValueError, match="precision"):
        R3MEncoder(R3MConfig(size=18), precision="bf16", device="cpu")


def test_config_round_trips_and_validates_like_jax():
    from r3m_tpu.utils.config import agent_to_r3m_config as jax_agent
    from r3m_tpu_torch.utils.config import agent_to_r3m_config

    d = dataclasses.asdict(JaxR3MConfig(size=0, image_size=64, vit_fused_attn="batched"))
    assert dataclasses.asdict(R3MConfig(**d)) == d
    assert {f.name for f in dataclasses.fields(R3MConfig)} == set(d)
    agent = {"size": "18", "lr": "linear(1e-4,1e-5,100)", "l2weight": "1e-5",
             "device": "cuda", "_target_": "r3m.R3M"}
    assert dataclasses.asdict(agent_to_r3m_config(agent)) == dataclasses.asdict(jax_agent(agent))
    assert r3m_tpu_torch.cleanup_config({"agent": agent}) == r3m_tpu.cleanup_config(
        {"agent": agent}
    )
    for bad in ({"size": 0, "remat": "conv_saved"}, {"vit_fused_attn": "yes"},
                {"size": 18, "vit_fused_attn": True}):
        with pytest.raises(ValueError) as want:
            JaxR3MConfig(**bad)
        with pytest.raises(ValueError) as got:
            R3MConfig(**bad)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError):
        agent_to_r3m_config({"lr": "cosine(1,2)"})


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port imports, in a fresh interpreter, with no JAX, no module of
    the JAX package and no pandas (the card machine's stack does not promise it)."""
    code = (
        "import pkgutil, sys, importlib, r3m_tpu_torch\n"
        "for m in pkgutil.walk_packages(r3m_tpu_torch.__path__, 'r3m_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'optax', 'r3m_tpu', 'pandas')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=root)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr
