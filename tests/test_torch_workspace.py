"""The port's training workspace and its CLI (`python -m r3m_tpu_torch.train_representation`)
on the CPU, and the slice as a whole against the JAX package's `Workspace`.

Runs are small: ResNet-18, 2 clips of 5 frames (decoded at 224 px, trained at 64 px crops
with ``+agent.image_size=64``), a few steps.

The JAX comparison starts both workspaces from one JAX ``snapshot.npz`` at step 0 with
``doaug=none`` and ``tcnweight=0 langweight=0``: no crop and no negative permutation enters
the loss, so the two packages' generators do not matter, and the batches are the same
because the sample streams and the decoders are (``tests/test_torch_data.py``). Two steps
and two evals: the losses in ``train.csv`` / ``eval.csv`` agree to rtol 1e-4 (the
gradients' global norm to 1e-3); the step-2 snapshots' parameters and BatchNorm statistics
to rtol 1e-4 (atol 1e-6) and Adam's moments to relative L2 1e-3 a leaf, the tolerances of
``tests/test_torch_train_step.py``. Its lr is 1e-6: the L1/L2 objective left has gradients
of order 1e-6, and Adam moves every element by ~lr whatever its size, so at 1e-4 the
elements whose gradient is rounding noise (near Adam's eps) move by up to lr in either
direction, and the first step overshoots, so the second gradient nearly cancels the first
in the moments. Its seed (16) gives batches without a ReLU input within rounding of 0 (a
flip moves the gradients upstream of it by ~1e-3, as that file says), and the test
asserts that of both steps' batches (``tests/test_torch_relu_margin.py``): seed 5, which
it used before, put one within 0.05 of a rounding there; 16 keeps 0.58 in both steps.
"""

import csv
import glob
import os
import shutil
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax

from r3m_tpu import checkpoint as jckpt
from r3m_tpu.data.ego4d import write_synthetic_dataset
from r3m_tpu.training import trainer as jtrainer
from r3m_tpu.training.workspace import Workspace as JaxWorkspace
from r3m_tpu.utils.config import agent_to_r3m_config as jax_agent_to_r3m_config
from r3m_tpu.utils.config import load_config as jax_load_config
from r3m_tpu_torch import train_representation as cli
from r3m_tpu_torch.checkpoint import load_snapshot, save_snapshot
from r3m_tpu_torch.convert import canonical_path, get_path
from r3m_tpu_torch.losses import draw_permutations
from r3m_tpu_torch.models.r3m import r3m_init
from r3m_tpu_torch.training import workspace as ws_mod
from r3m_tpu_torch.training.workspace import Workspace
from r3m_tpu_torch.utils.config import load_config
from tests.test_torch_relu_margin import assert_relu_margin, step_forward

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "cfgs", "config_rep.yaml")
RTOL = 1e-4
GRAD_REL_L2 = 1e-3
TIMING = {"step", "sample_time", "update_time", "step_time"}


@pytest.fixture(autouse=True)
def _remove_tmp_path(tmp_path):
    """Each test's temporary directory goes when the test ends: the suite's files add up."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("ws_port_data")
    yield write_synthetic_dataset(
        str(d), n_videos=4, min_len=10, max_len=16,
        size=64, captions=["C opens the door", "C picks up a cup"])
    shutil.rmtree(d, ignore_errors=True)


TORCH_THREADS = 2  # the suite runs several files at once: one process a file, few threads


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _free_disk(tmp_path):
    """A ResNet-18 train snapshot is ~134 MB: each test's files go when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _overrides(data, **kw):
    base = {"datapath": data, "batch_size": 2, "train_steps": 3, "eval_freq": 2,
            "num_workers": 2, "agent.size": 18, "agent.langweight": 0.0,
            "compute_dtype": "float32", "n_devices": 1, "+agent.image_size": 64,
            "compilation_cache_dir": "", **kw}
    return [f"{k}={v}" for k, v in base.items()]


def _cfg(data, **kw):
    return load_config(CONFIG, overrides=_overrides(data, **kw))


def _run(cfg, work, train=True):
    ws = Workspace(cfg, work_dir=str(work), device="cpu")
    try:
        if train:
            ws.train()
    finally:
        ws.close()
    return ws


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("overrides", [
    [],
    ["batch_size=4", "agent.size=18", "doaug=none", "agent.langweight=1.0"],
    ["lr=linear(1e-4,1e-5,10)", "+extra.key=3", "datapath=/data", "log_dir=${datapath}/run",
     "agent.l1weight=2e-5", "n_devices=~"],
])
def test_load_config_equals_jax(overrides):
    got = load_config(CONFIG, overrides=overrides)
    assert got == jax_load_config(CONFIG, overrides=overrides)
    assert got.agent.bs == got.batch_size and got.agent["lr"] == got.lr


@pytest.mark.parametrize("bad,error", [
    (["batch_sise=4"], KeyError), (["agent.sise=3"], KeyError), (["batch_size"], ValueError),
])
def test_load_config_rejects_what_jax_rejects(bad, error):
    with pytest.raises(error):
        jax_load_config(CONFIG, overrides=bad)
    with pytest.raises(error):
        load_config(CONFIG, overrides=bad)


def _step_forwards(monkeypatch):
    """The `step_forward` of every train step the port's `Workspace` takes from now on,
    in order. Its negatives are drawn here: the runs that use this have no loss that
    reads them."""
    forwards = []
    make = ws_mod.make_train_step

    def recording(mcfg, bert, doaug="none", **kw):
        step = make(mcfg, bert, doaug=doaug, **kw)

        def recorded(state, batch, **step_kw):
            perms = draw_permutations(torch.Generator().manual_seed(0),
                                      batch["images"].shape[0], mcfg.num_negatives)
            forwards.append(step_forward(mcfg, state.model, batch, perms, bert=bert,
                                         doaug=doaug))
            return step(state, batch, **step_kw)

        return recorded

    monkeypatch.setattr(ws_mod, "make_train_step", recording)
    return forwards


def test_workspace_matches_the_jax_workspace(data, tmp_path, capsys, monkeypatch):
    """Two steps and two evals from one JAX snapshot at step 0, in both packages."""
    kw = dict(train_steps=2, eval_freq=1, doaug="none", **{"agent.tcnweight": 0.0},
              seed=16, metric_flush=1, lr="1e-6")
    jcfg = jax_load_config(CONFIG, overrides=_overrides(data, **kw))
    start = tmp_path / "start"
    start.mkdir()
    snap = jckpt.save_train_snapshot(str(start), jtrainer.create_train_state(
        jax_agent_to_r3m_config(jcfg["agent"]), jax.random.PRNGKey(0)), keep_step_copy=False)
    jcfg["load_snap"] = snap
    jws = JaxWorkspace(jcfg, work_dir=str(tmp_path / "jax"))
    try:
        jws.train()
    finally:
        jws.close()
    forwards = _step_forwards(monkeypatch)
    pws = _run(_cfg(data, load_snap=snap, **kw), tmp_path / "port")
    assert pws.global_step == 2 and len(forwards) == 2
    for forward in forwards:
        assert_relu_margin(forward, "16 (the workspace's)")

    for name in ("train.csv", "eval.csv"):
        want, got = _rows(tmp_path / "jax" / name), _rows(tmp_path / "port" / name)
        assert len(got) == len(want) > 0, name
        for g, w in zip(got, want):
            assert g["step"] == w["step"]
            losses = set(w) - TIMING
            assert losses <= set(g), (name, losses - set(g))
            for k in losses:
                # grad_norm, the global norm of the gradients, to their tolerance
                rtol = GRAD_REL_L2 if k == "grad_norm" else RTOL
                np.testing.assert_allclose(float(g[k]), float(w[k]), rtol=rtol, atol=1e-7,
                                           err_msg=f"{name} {k}")

    jtree, _ = load_snapshot(str(tmp_path / "jax" / "snapshot_2.npz"))
    ptree, pmeta = load_snapshot(str(tmp_path / "port" / "snapshot_2.npz"))
    assert pmeta["global_step"] == 2

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, path + (k,))
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from leaves(v, path + (i,))
        else:
            yield path, np.asarray(tree)

    for group in ("params", "batch_stats"):
        want, got = dict(leaves(jtree[group])), dict(leaves(ptree[group]))
        assert got.keys() == want.keys() and len(got) > 20, group
        for path, w in want.items():
            np.testing.assert_allclose(got[path], w, rtol=RTOL, atol=1e-6, err_msg=str(path))
    # Adam's moments, the gradients' running mean and mean square, to their tolerance
    for i in (1, 2):
        want, got = dict(leaves(jtree["opt_state"][0][i])), dict(leaves(ptree["opt_state"][0][i]))
        assert got.keys() == want.keys()
        for path, w in want.items():
            err = np.linalg.norm(got[path] - w) / np.linalg.norm(w)
            assert err <= GRAD_REL_L2, f"moment {i} {path}: relative L2 error {err}"

    # the JAX snapshot's stream counters carry another fingerprint: the stream restarts
    capsys.readouterr()
    ws = _run(_cfg(data, load_snap=str(tmp_path / "jax" / "snapshot_2.npz"), **kw),
              tmp_path / "port2", train=False)
    assert ws.global_step == 2 and ws._train_stream_pos0 == 0
    assert "JAX package snapshot" in capsys.readouterr().out


def _state(ws):
    s = ws.state
    return ({k: v.detach().clone() for k, v in s.model.state_dict().items()},
            {i: {k: v.clone() for k, v in st.items() if torch.is_tensor(v)}
             for i, st in enumerate(s.optimizer.state.values())},
            s.generator.get_state(), s.step)


def test_resume_is_bit_equal_to_an_uninterrupted_run(data, tmp_path):
    """3 steps, snapshot, resume to 6 against 6 steps straight: parameters, BatchNorm
    statistics, Adam moments and the generator, bit for bit."""
    _run(_cfg(data), tmp_path / "a")
    resumed = _run(_cfg(data, train_steps=6, snapshot="false"), tmp_path / "a")
    assert resumed._train_stream_pos0 == 3 and resumed._val_batches == 3
    straight = _run(_cfg(data, train_steps=6, snapshot="false"), tmp_path / "b")
    (p1, o1, g1, s1), (p2, o2, g2, s2) = _state(resumed), _state(straight)
    assert s1 == s2 == 6
    assert p1.keys() == p2.keys() and any(k.endswith("running_var") for k in p1)
    for k in p1:
        assert torch.equal(p1[k], p2[k]), k
    assert len(o1) == len(o2) > 0
    for i in o1:
        for k in o1[i]:
            assert torch.equal(o1[i][k], o2[i][k]), (i, k)
    assert torch.equal(g1, g2)
    # and the evals of the resumed run's steps equal the uninterrupted run's
    want = {r["step"]: r for r in _rows(tmp_path / "b" / "eval.csv")}
    for r in _rows(tmp_path / "a" / "eval.csv"):
        assert r == want[r["step"]]


def test_stream_restarts_with_a_reason_after_a_dataset_change(data, tmp_path, capsys):
    _run(_cfg(data, train_steps=2), tmp_path)  # one snapshot, at step 1
    same = _run(_cfg(data, train_steps=2), tmp_path, train=False)
    assert same.global_step == 1 and same._train_stream_pos0 == 1
    capsys.readouterr()
    other = _run(_cfg(data, train_steps=2, alpha=0.4), tmp_path, train=False)
    assert other.global_step == 1 and other._train_stream_pos0 == 0
    assert "another stream fingerprint" in capsys.readouterr().out
    capsys.readouterr()
    wider = _run(_cfg(data, train_steps=2, batch_size=4), tmp_path, train=False)
    assert wider._train_stream_pos0 == 0 and "1 x 4" in capsys.readouterr().out


def test_auto_resume_falls_back_past_a_corrupt_rolling_snapshot(data, tmp_path):
    _run(_cfg(data), tmp_path)
    assert sorted(os.listdir(tmp_path)) == ["eval.csv", "snapshot.npz", "snapshot_1.npz",
                                            "snapshot_3.npz", "train.csv"]
    (tmp_path / "snapshot.npz").write_bytes(b"\x00" * 100)
    (tmp_path / "snapshot_3.npz").write_bytes(b"PK\x03\x04")
    ws = _run(_cfg(data), tmp_path, train=False)
    assert ws.global_step == 1

    # a snapshot that fails half-way through loading (a leaf of another shape near the
    # end) leaves nothing of itself in the state when no candidate loads
    tree, meta = load_snapshot(str(tmp_path / "snapshot_1.npz"))
    _, path, _ = canonical_path("convnet.layer4.1.conv2.weight")
    get_path(tree["params"], path[:-1])[path[-1]] = np.zeros((1,), np.float32)
    save_snapshot(str(tmp_path / "snapshot.npz"), tree, meta)
    for p in glob.glob(str(tmp_path / "snapshot_*.npz")):
        os.remove(p)
    ws = _run(_cfg(data), tmp_path, train=False)
    fresh = r3m_init(ws.model_cfg, seed=1).state_dict()
    assert ws.global_step == 0
    for k, v in ws.state.model.state_dict().items():
        assert torch.equal(v, fresh[k]), k


def test_keep_snapshots_prunes(data, tmp_path):
    _run(_cfg(data, keep_snapshots=1, eval_freq=1, train_steps=2), tmp_path)
    assert [os.path.basename(p) for p in glob.glob(str(tmp_path / "snapshot_*.npz"))] == [
        "snapshot_2.npz"]
    assert os.path.exists(tmp_path / "snapshot.npz")


def test_a_stop_request_writes_a_final_snapshot(data, tmp_path):
    cfg = _cfg(data, train_steps=50, eval_freq=1000, metric_flush=1)
    ws = Workspace(cfg, work_dir=str(tmp_path), device="cpu")
    try:
        cli._install_sigterm(ws)  # the CLI's wiring: SIGTERM -> request_stop
        os.kill(os.getpid(), signal.SIGTERM)
        assert ws._stop_requested
        ws._stop_requested = False
        flush = ws._flush_train_metrics

        def stop_at_3(pending, win_t0=None):
            flush(pending, win_t0)
            if ws.global_step >= 3:
                ws.request_stop()

        ws._flush_train_metrics = stop_at_3
        ws.train()
    finally:
        ws.close()
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
    assert ws.global_step == 3
    _, meta = load_snapshot(str(tmp_path / "snapshot.npz"))
    assert meta["global_step"] == 3 and meta["data_stream"]["train_batches"] == 3


class _DeferredWriter:
    """A snapshot writer that writes only at the next `wait`: later steps run first."""

    def __init__(self):
        self.pending = []

    def submit(self, fn):
        self.wait()
        self.pending.append(fn)

    def wait(self):
        while self.pending:
            self.pending.pop()()


def test_a_snapshot_holds_its_steps_values_after_later_steps(data, tmp_path):
    """The step changes the state in place: the snapshot's host copy is taken when it is
    submitted, so a write that lands after step 2 still holds step 1's values."""
    ws = Workspace(_cfg(data, train_steps=2, eval_freq=1000), work_dir=str(tmp_path),
                   device="cpu")
    seen = {}
    step = ws.train_step

    def recording_step(state, batch):
        state, metrics = step(state, batch)
        seen[state.step] = {k: v.detach().clone() for k, v in state.model.named_parameters()}
        return state, metrics

    ws.train_step = recording_step
    ws._snap_writer = _DeferredWriter()
    try:
        ws.train()  # eval and a (deferred) snapshot at step 1 only
    finally:
        ws.close()
    tree, meta = load_snapshot(str(tmp_path / "snapshot_1.npz"))
    assert meta["global_step"] == 1 and ws.global_step == 2
    _, path, _ = canonical_path("convnet.bn1.bias")
    bias = get_path(tree["params"], path)
    np.testing.assert_array_equal(bias, seen[1]["convnet.bn1.bias"].numpy())
    assert not np.array_equal(bias, seen[2]["convnet.bn1.bias"].numpy())


class _PrefetchHarness:
    """The workspace's device prefetch over a stand-in `_place` that counts."""

    def __init__(self):
        self.placed = 0

    def _place(self, batch):
        self.placed += 1
        return batch, None

    _device_prefetch = Workspace._device_prefetch


def test_device_prefetch_runs_no_thread_at_depth_zero():
    h = _PrefetchHarness()
    before = threading.active_count()
    gen = h._device_prefetch(iter([{"x": 1}, {"x": 2}]), depth=0)
    assert [b["x"] for b, _ in gen] == [1, 2]
    assert h.placed == 2 and threading.active_count() == before


def test_device_prefetch_bounds_resident_batches():
    h = _PrefetchHarness()
    gen = h._device_prefetch(({"i": i} for i in range(1000)), depth=2)
    assert next(gen)[0]["i"] == 0
    deadline = time.time() + 5.0
    while h.placed < 3 and time.time() < deadline:
        time.sleep(0.01)
    time.sleep(0.3)  # the producer now waits for a slot
    assert h.placed == 3  # the one in use and `depth` waiting, never more
    gen.close()


def test_device_prefetch_surfaces_a_producer_error_and_ends_cleanly():
    def failing():
        yield {"ok": True}
        raise OSError("decode failed")

    gen = _PrefetchHarness()._device_prefetch(failing(), depth=2)
    assert next(gen)[0]["ok"]
    with pytest.raises(RuntimeError, match="device prefetch"):
        for _ in gen:
            pass
    gen = _PrefetchHarness()._device_prefetch(iter([{"a": 1}]), depth=2)
    assert [b["a"] for b, _ in gen] == [1]


def test_a_profile_window_past_train_steps_is_closed(data, tmp_path):
    prof = tmp_path / "trace"
    _run(_cfg(data, train_steps=12, eval_freq=100, profile_dir=str(prof), snapshot="false"),
         tmp_path / "run")
    assert glob.glob(str(prof / "*.pt.trace.json"))
    p = torch.profiler.profile()  # the profiler is free again
    p.start()
    p.stop()


def test_language_run_snapshot_serves_rewards(data, tmp_path):
    """A langweight=1.0 run (a small DistilBERT .npz and vocab) -> its snapshot ->
    `R3MRewardModel.from_snapshot`."""
    import dataclasses

    from r3m_tpu_torch.checkpoint import save_snapshot
    from r3m_tpu_torch.convert import distilbert_tree
    from r3m_tpu_torch.models.distilbert import DistilBert, DistilBertConfig
    from r3m_tpu_torch.reward import R3MRewardModel

    torch.manual_seed(0)
    bert = DistilBert(DistilBertConfig(vocab_size=30, dim=32, n_layers=1, n_heads=2,
                                       hidden_dim=64, max_position_embeddings=16))
    save_snapshot(str(tmp_path / "bert.npz"), distilbert_tree(bert.state_dict()),
                  {"bert_config": dataclasses.asdict(bert.cfg)})
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "opens", "the", "door", "picks", "up", "a",
             "cup"]
    (tmp_path / "vocab.txt").write_text("\n".join(vocab) + "\n")
    kw = {"agent.langweight": 1.0, "agent.hidden_dim": 16, "bert_weights": tmp_path / "bert.npz",
          "vocab_path": tmp_path / "vocab.txt", "lang_max_len": 8, "train_steps": 2}
    ws = _run(_cfg(data, **kw), tmp_path / "run")
    assert ws.model_cfg.lang_dim == 32 and ws.tokenizer is not None
    rows = _rows(tmp_path / "run" / "train.csv")
    assert "rewloss" in rows[0] and np.isfinite(float(rows[-1]["full_loss"]))

    rm = R3MRewardModel.from_snapshot(str(tmp_path / "run" / "snapshot.npz"),
                                      str(tmp_path / "bert.npz"), str(tmp_path / "vocab.txt"),
                                      device="cpu")
    assert rm.lang_max_len == 8
    im = np.full((1, 3, 64, 64), 127, np.uint8)
    r = rm(im, im + 10, ["picks up a cup"])
    assert r.shape == (1,) and torch.isfinite(r).all()

    no_vocab = dict(kw, vocab_path="")
    with pytest.raises(ValueError, match="vocab_path"):
        _run(_cfg(data, **no_vocab), tmp_path / "v", train=False)
    with pytest.raises(ValueError, match="bert_weights"):
        _run(_cfg(data, **dict(kw, bert_weights="")), tmp_path / "b", train=False)


@pytest.mark.parametrize("setting", ["n_devices=2", "n_slices=2", "distributed_init=true"])
def test_data_parallel_settings_raise(data, tmp_path, setting, capsys):
    """What each data-parallel setting does in one process with no launcher: two devices
    need two processes, so ``n_devices=2`` raises (the CLI starts the ranks itself);
    ``n_slices`` is accepted with no effect, and says so; ``distributed_init=true`` joins
    a process group of one rank and trains through the data-parallel step."""
    import torch.distributed as dist

    key, value = setting.split("=")
    cfg = _cfg(data, **{key: value})
    if key == "n_devices":
        with pytest.raises(ValueError, match="one process a device"):
            Workspace(cfg, work_dir=str(tmp_path), device="cpu")
        return
    try:
        ws = _run(cfg, tmp_path, train=key == "distributed_init")
        out = capsys.readouterr().out
        if key == "n_slices":
            assert "n_slices=2 (NCCL arranges" in out and not dist.is_initialized()
        else:
            assert "[distributed] rank 0/1 (gloo, cpu" in out and ws._mesh is True
            rows = _rows(tmp_path / "train.csv")
            assert ws.global_step == 3 and np.isfinite(float(rows[-1]["full_loss"]))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _cli(args, cwd, code=None):
    cmd = [sys.executable, "-c", code] if code else [
        sys.executable, "-m", "r3m_tpu_torch.train_representation"]
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": str(TORCH_THREADS)}
    return subprocess.run(cmd + args, cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_cli_trains_resumes_and_requeues(data, tmp_path):
    run = tmp_path / "run"
    args = _overrides(data, train_steps=1, eval_freq=1) + [f"log_dir={run}"]
    out = _cli(["--device", "cpu", *args], tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[data] JPEG decoder: native" in out.stdout
    _, meta = load_snapshot(str(run / "snapshot.npz"))
    assert meta["global_step"] == 1

    out = _cli(["--device=cpu", *args[:-1], f"log_dir={run}", "train_steps=2"], tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "data stream fast-forwarded: train 1" in out.stdout
    assert load_snapshot(str(run / "snapshot.npz"))[1]["global_step"] == 2

    # --retries: a crash in the first attempt's train() rebuilds the workspace
    crash = ("import sys\n"
             "from r3m_tpu_torch.training import workspace as w\n"
             "from r3m_tpu_torch import train_representation as cli\n"
             "train, calls = w.Workspace.train, []\n"
             "def flaky(self):\n"
             "    calls.append(1)\n"
             "    if len(calls) == 1:\n"
             "        raise RuntimeError('injected crash')\n"
             "    return train(self)\n"
             "w.Workspace.train = flaky\n"
             "cli.main(sys.argv[1:])\n"
             "print('attempts', len(calls))\n")
    rq = tmp_path / "rq"
    out = _cli(["--device", "cpu", "--retries=2", *args[:-1], f"log_dir={rq}",
                "snapshot=false"], tmp_path, code=crash)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[requeue] attempt 1/2 after RuntimeError: injected crash" in out.stdout
    assert "attempts 2" in out.stdout
    out = _cli(["--device", "cpu", *args[:-1], f"log_dir={rq}"], tmp_path, code=crash)
    assert out.returncode != 0 and "injected crash" in out.stderr

    out = _cli(args, tmp_path)  # no --device: the card, which this host lacks
    if not torch.cuda.is_available():
        assert out.returncode != 0 and "CUDA device" in out.stderr


def test_workspace_is_exported_lazily():
    import r3m_tpu_torch

    assert r3m_tpu_torch.Workspace is ws_mod.Workspace
