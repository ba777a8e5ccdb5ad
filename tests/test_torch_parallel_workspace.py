"""The port's data-parallel surface around the step, on the CPU: the workspace and
``python -m r3m_tpu_torch.train_representation`` at world size 2 (gloo, ranks that the
CLI starts itself), serving over a mesh of CPU devices (`R3MEncoder(mesh=...)`, ``embed
--n-devices``), `make_mesh`, `init_distributed` and `launch_local`.

The workspace runs ResNet-18 on 64 px crops of an Ego4D-layout dataset (decoded at 64 px),
a global batch of 4 clips, TCN + L1/L2 losses, f32. Its first step at world 2 is held to
one single-process step of the port on the two ranks' first batches put together in
`local_rows` order, from the same seeded state, which draws the same crops and
permutations: loss rtol 1e-4 (the data-parallel BatchNorm sums E[x^2] - E[x]^2 where the
single-process one is torch's). Serving over two CPU devices is held to one device to
rtol 1e-5 (atol 1e-5), as the JAX package's mesh-serving test holds its mesh.
"""

import dataclasses
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from r3m_tpu.data.ego4d import write_synthetic_dataset
from r3m_tpu_torch import embed
from r3m_tpu_torch.checkpoint import load_snapshot, save_train_snapshot
from r3m_tpu_torch.data.ego4d import Ego4DDataset
from r3m_tpu_torch.data.pipeline import DataPipeline
from r3m_tpu_torch.models.r3m import R3MConfig, R3MEncoder, r3m_init
from r3m_tpu_torch.models.resnet import ResNet
from r3m_tpu_torch.models.vit import B32, ViT
from r3m_tpu_torch.parallel import mesh as pmesh
from r3m_tpu_torch.parallel.mesh import launch_local, local_rows, make_mesh
from r3m_tpu_torch.training.trainer import create_train_state, make_train_step
from r3m_tpu_torch.training.workspace import Workspace
from r3m_tpu_torch.utils.config import agent_to_r3m_config, load_config
from tests.test_torch_parallel_worker import fail_on_rank_1, sleep_forever, stop_on_rank_1

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "cfgs", "config_rep.yaml")
WORLD, GLOBAL_BS = 2, 4


@pytest.fixture(autouse=True)
def _remove_tmp_path(tmp_path):
    """Each test's temporary directory goes when the test ends: the suite's files add up."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("dp_data")
    yield write_synthetic_dataset(
        str(d), n_videos=6, min_len=10, max_len=16,
        size=64, captions=["C opens the door", "C picks up a cup"])
    shutil.rmtree(d, ignore_errors=True)


def _overrides(data, **kw):
    base = {"datapath": data, "batch_size": GLOBAL_BS, "train_steps": 1, "eval_freq": 1,
            "num_workers": 1, "agent.size": 18, "agent.langweight": 0.0,
            "compute_dtype": "float32", "n_devices": WORLD, "+agent.image_size": 64,
            "metric_flush": 1, **kw}
    return [f"{k}={v}" for k, v in base.items()]


def _cli(args, cwd):
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-m", "r3m_tpu_torch.train_representation",
                          "--device", "cpu", *args], cwd=cwd, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return out.stdout


def _csv(path):
    import csv

    with open(path) as f:
        return list(csv.DictReader(f))


def _first_batches(cfg):
    """Each rank's first train batch, as its workspace draws it: the manifest shard and
    seed of the rank, the workspace's own batcher."""
    out = []
    for r in range(WORLD):
        ds = Ego4DDataset(cfg["datapath"], alpha=float(cfg["alpha"]), seed=cfg["seed"] + r,
                          shard_index=r, num_shards=WORLD)
        fake = types.SimpleNamespace(cfg=cfg, _local_bs=GLOBAL_BS // WORLD)
        pipe = DataPipeline(Workspace._make_batcher(fake, ds))
        try:
            out.append(next(pipe))
        finally:
            pipe.close()
    return out


def test_cli_trains_at_world_2_and_resumes_every_rank(data, tmp_path):
    """``n_devices=2`` with no launcher: the CLI starts two gloo ranks. Rank 0 alone
    writes the CSVs and the snapshots; a second run resumes both ranks, each
    fast-forwarding its own stream; the first step's loss is the single-process step's on
    the ranks' batches together."""
    run = tmp_path / "run"
    out = _cli(_overrides(data) + [f"log_dir={run}"], tmp_path)
    assert out.count("[distributed] rank") == 2 and "rank 1 of 2" in out
    assert sorted(os.listdir(run)) == ["eval.csv", "snapshot.npz", "snapshot_1.npz",
                                       "train.csv"]
    train, evals = _csv(run / "train.csv"), _csv(run / "eval.csv")
    assert [r["step"] for r in train] == ["1"] and [r["step"] for r in evals] == ["1"]
    _, meta = load_snapshot(str(run / "snapshot.npz"))
    ds_meta = meta["data_stream"]
    assert (meta["global_step"], ds_meta["num_hosts"], ds_meta["local_batch_size"]) == (1, 2, 2)

    cfg = load_config(CONFIG, overrides=_overrides(data))
    mcfg = agent_to_r3m_config(cfg["agent"])
    batches = _first_batches(cfg)
    rows = np.concatenate([local_rows(GLOBAL_BS, 1, WORLD, r) for r in range(WORLD)])
    together = {k: np.concatenate([b[k] for b in batches])[np.argsort(rows)]
                for k in batches[0] if k != "captions"}
    state = create_train_state(mcfg, cfg["seed"], device="cpu")
    _, metrics = make_train_step(mcfg, doaug=cfg["doaug"], device="cpu")(state, together)
    np.testing.assert_allclose(float(train[0]["full_loss"]), float(metrics["full_loss"]),
                               rtol=1e-4)

    out = _cli(_overrides(data, train_steps=2) + [f"log_dir={run}"], tmp_path)
    assert out.count("[resume] data stream fast-forwarded: train 1 / val 1") == 2
    _, meta = load_snapshot(str(run / "snapshot.npz"))
    assert meta["global_step"] == 2 and meta["data_stream"]["train_batches"] == 2


def test_a_stop_request_on_one_rank_stops_every_rank_after_the_same_step(data, tmp_path):
    """Rank 1 is asked to stop after step 2 (its SIGTERM handler's call); the flag is
    all-reduced at each metric flush (every step here), so both ranks stop after step 2,
    and rank 0 writes the final snapshot."""
    out = str(tmp_path / "rank%d.txt")
    overrides = _overrides(data, train_steps=10, eval_freq=100) + [f"log_dir={tmp_path}"]
    launch_local(stop_on_rank_1, WORLD, CONFIG, overrides, str(tmp_path / "run"), out,
                 timeout=240)
    assert [open(out % r).read() for r in range(WORLD)] == ["2", "2"]
    assert "snapshot_2.npz" in os.listdir(tmp_path / "run")


def test_workspace_refuses_a_world_it_does_not_have(data, tmp_path):
    cfg = load_config(CONFIG, overrides=_overrides(data, batch_size=3, n_devices=1))
    with pytest.raises(ValueError, match="one process a device"):
        Workspace(load_config(CONFIG, overrides=_overrides(data)), work_dir=str(tmp_path),
                  device="cpu")
    try:
        pmesh.init_distributed("true", device="cpu")
        with pytest.raises(ValueError, match="n_devices=2 but the job has 1 ranks"):
            Workspace(load_config(CONFIG, overrides=_overrides(data)),
                      work_dir=str(tmp_path), device="cpu")
        ws = Workspace(cfg, work_dir=str(tmp_path), device="cpu")  # world 1: batch 3 fits
        ws.close()
    finally:
        dist.destroy_process_group()


def _encoder_pair(cfg, sd, precision):
    one = R3MEncoder(cfg, sd, precision=precision, device="cpu")
    two = R3MEncoder(cfg, sd, precision=precision,
                     mesh=make_mesh(devices=["cpu", "cpu"]))
    return one, two


@pytest.mark.parametrize("size,precision", [(18, "parity"), (18, "fast"), (0, "parity")])
def test_mesh_serving_equals_one_device(size, precision):
    torch.manual_seed(0)
    cfg = R3MConfig(size=size, image_size=32 if size else 64)
    net = ResNet(18) if size else ViT(dataclasses.replace(B32, image_size=64))
    one, two = _encoder_pair(cfg, net.state_dict(), precision)
    hw = 32 if size else 64
    obs = np.random.default_rng(0).integers(0, 256, (4, 3, hw, hw), dtype=np.uint8)
    torch.testing.assert_close(two(obs), one(obs), rtol=1e-5, atol=1e-5)
    assert len(two._replicas) == 2 and two._replicas[1] is not two._replicas[0]
    with pytest.raises(ValueError, match="not divisible"):
        two(obs[:3])


def test_mesh_serving_refolds_every_replica():
    torch.manual_seed(0)
    cfg = R3MConfig(size=18, image_size=32)
    _, two = _encoder_pair(cfg, ResNet(18).state_dict(), "parity")
    obs = np.random.default_rng(1).integers(0, 256, (4, 3, 32, 32), dtype=np.uint8)
    before = two(obs)
    other = ResNet(18)
    two.convnet.load_state_dict(other.state_dict())
    want = R3MEncoder(cfg, other.state_dict(), device="cpu")(obs)
    got = two(obs)
    assert not torch.allclose(got, before)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)  # both halves refreshed


def test_embed_n_devices_on_the_cpu(tmp_path):
    from PIL import Image

    folder = tmp_path / "frames"
    folder.mkdir()
    rng = np.random.default_rng(0)
    for i in range(5):
        Image.fromarray(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)).save(
            folder / f"f{i}.png")
    cfg = R3MConfig(size=18, image_size=32, langweight=0.0)
    state = create_train_state(cfg, 0, model=r3m_init(cfg, 0), device="cpu")
    snap = save_train_snapshot(str(tmp_path), state, cfg, keep_step_copy=False)
    outs = {}
    for n in (0, 2):
        path = str(tmp_path / f"e{n}.npz")
        embed.main([str(folder), "--snapshot", snap, "--out", path, "--device", "cpu",
                    "--batch", "3", "--n-devices", str(n)])
        with np.load(path) as z:
            outs[n] = z["embeddings"]
    assert outs[2].shape == (5, 512)
    np.testing.assert_allclose(outs[2], outs[0], rtol=1e-5, atol=1e-5)


def test_make_mesh_checks_what_it_is_asked():
    mesh = make_mesh(2, devices=["cpu"] * 3)
    assert mesh.devices == (torch.device("cpu"),) * 2 and len(mesh) == 2
    with pytest.raises(ValueError, match="only 2 visible"):
        make_mesh(3, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="n_slices=3"):
        make_mesh(devices=["cpu"] * 4, n_slices=3)
    assert len(make_mesh(devices=["cpu"] * 4, n_slices=2)) == 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(1)


@pytest.mark.parametrize("env,want", [
    ({}, None),
    ({"RANK": "3", "WORLD_SIZE": "8", "MASTER_ADDR": "h", "LOCAL_RANK": "1",
      "LOCAL_WORLD_SIZE": "4"}, (3, 8, 1, 4)),
    ({"RANK": "3", "WORLD_SIZE": "8"}, None),  # no MASTER_ADDR: not a torchrun launch
    ({"SLURM_PROCID": "5", "SLURM_NTASKS": "16", "SLURM_LOCALID": "1",
      "SLURM_NTASKS_PER_NODE": "8(x2)"}, (5, 16, 1, 8)),
])
def test_init_distributed_reads_the_launchers(monkeypatch, env, want):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
              "SLURM_PROCID", "SLURM_NTASKS", "SLURM_LOCALID", "SLURM_NTASKS_PER_NODE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert pmesh._launch_env() == want
    assert pmesh.launched() == (want is not None)


def test_init_distributed_joins_only_when_asked(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "SLURM_PROCID", "SLURM_NTASKS"):
        monkeypatch.delenv(k, raising=False)
    for mode in ("auto", "false", False, None):
        assert pmesh.init_distributed(mode, device="cpu") == torch.device("cpu")
        assert not dist.is_initialized()
    with pytest.raises(ValueError, match="auto, true or false"):
        pmesh.init_distributed("sometimes", device="cpu")
    try:
        assert pmesh.init_distributed(True, device="cpu") == torch.device("cpu")
        assert dist.is_initialized() and pmesh.world() == 1 and pmesh.is_lead()
        assert dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()
    # NCCL cannot put two ranks on one card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for k, v in {"RANK": "1", "WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1",
                 "MASTER_PORT": "1", "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "2"}.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="NCCL cannot put two ranks"):
        pmesh.init_distributed("auto", device="cuda:0")
    assert not dist.is_initialized()


def test_launch_local_stops_the_job_when_a_rank_fails(tmp_path):
    marker = str(tmp_path / "rank0_ran")
    with pytest.raises(RuntimeError, match="rank exit codes"):
        launch_local(fail_on_rank_1, 2, marker, timeout=120)
    assert os.path.exists(marker)
    with pytest.raises(RuntimeError, match="timed out"):
        launch_local(sleep_forever, 1, timeout=3)
