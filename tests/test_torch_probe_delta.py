"""``python -m r3m_tpu_torch.probe_delta`` end to end on the CPU at a tiny size.

ResNet-18 at 32 px, 6 videos of 8 frames, 3 steps of 4 clips, a held-out set of 6 videos
of 5 frames, one decode worker: the reach world is written, `Workspace` trains on it with
the README's settings and the frozen random DistilBERT, and the three encoders are scored.
`PROBE_DELTA.json` carries the JAX script's keys and three rows with finite metrics, the
caption contrast included; ``--skip-train`` rescores from the cached probe set and the
snapshots and gives the same rows; the ``bert.npz`` it wrote loads in the JAX package's
`load_bert_params` and in the port's `load_bert` to the same tensors. With the JAX
script's own DistilBERT draw in ``--run``, the port's ``--skip-train`` scores the same
snapshots as the JAX script's to the same reward-order and caption-contrast accuracies.
"""

import importlib.util
import json
import os
import shutil
import sys

import numpy as np
import pytest

from r3m_tpu.training.workspace import load_bert_params
from r3m_tpu_torch import probe_delta
from r3m_tpu_torch.convert import distilbert_tree
from r3m_tpu_torch.models.distilbert import load_bert

SIZES = ["--steps", "3", "--bs", "4", "--size", "18", "--image-size", "32", "--videos", "6",
         "--frames", "8", "--probe-videos", "6", "--probe-frames", "5", "--workers", "1"]
ARGS = ["--device", "cpu", *SIZES]
_JAX_SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "scripts", "probe_delta.py")
JAX_KEYS = {"steps", "scored_snapshot_step", "doaug", "size", "probe_frames", "rows"}
ENCODERS = ["random_init(x3)", "step0_snapshot", "trained"]


@pytest.fixture(autouse=True)
def _remove_tmp_path(tmp_path):
    """Each test's temporary directory goes when the test ends: the suite's files add up."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _result(run):
    with open(os.path.join(run, "PROBE_DELTA.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("probe")
    path = str(d / "run")
    assert probe_delta.main(["--run", path, *ARGS]) == 0
    yield path
    shutil.rmtree(d, ignore_errors=True)


def test_probe_delta_end_to_end(run):
    res = _result(run)
    assert JAX_KEYS <= set(res)
    assert res["steps"] == 3 and res["size"] == 18 and res["doaug"] == "rctraj"
    assert res["scored_snapshot_step"] == 1  # eval_freq 100: the snapshot of step 1
    assert res["probe_frames"] == 30
    assert [r["encoder"] for r in res["rows"]] == ENCODERS
    for r in res["rows"]:
        for m in (*probe_delta.METRICS, "reward_order_acc", "lang_contrast_acc"):
            assert np.isfinite(r[m]) and np.isfinite(r[m + "_std"]), (r["encoder"], m)
        assert 0.0 <= r["lang_contrast_acc"] <= 1.0
    assert res["rows"][0]["n_samples"] == 9 and res["rows"][2]["n_samples"] == 3
    assert res["train_frames_per_s"] > 0 and all(v >= 0 for v in res["seconds"].values())
    names = set(os.listdir(run))
    assert {"init_snapshot.npz", "snapshot.npz", "bert.npz", "train.csv",
            "probe_set_6x5_32.npz"} <= names


def test_skip_train_rescores_the_same_rows(run):
    first = _result(run)
    assert probe_delta.main(["--run", run, "--skip-train", *ARGS]) == 0
    again = _result(run)
    assert again["rows"] == first["rows"]
    assert again["scored_snapshot_step"] == first["scored_snapshot_step"]
    assert again["train_frames_per_s"] is None and again["seconds"]["train"] == 0.0


def test_bert_npz_loads_in_both_packages(run):
    path = os.path.join(run, "bert.npz")
    tree, cfg = load_bert_params(path)
    bert = load_bert(path, device="cpu")
    assert (cfg.dim, cfg.n_layers, cfg.n_heads, cfg.vocab_size) == (
        bert.cfg.dim, bert.cfg.n_layers, bert.cfg.n_heads, bert.cfg.vocab_size) == (
        768, 6, 12, 30522)
    got = distilbert_tree(bert.state_dict())

    def leaves(t, prefix=""):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from leaves(v, f"{prefix}/{k}")
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                yield from leaves(v, f"{prefix}/{i}")
        else:
            yield prefix, np.asarray(t)

    want = dict(leaves(tree))
    have = dict(leaves(got))
    assert set(have) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(have[k], v, err_msg=k)


def test_jax_drawn_bert_makes_both_probes_agree(run, tmp_path, monkeypatch):
    """One trained run, copied twice, with the JAX script's DistilBERT
    (``distilbert_init(PRNGKey(9))``, saved as the JAX script saves it) in both copies:
    the JAX script and the port, each with ``--skip-train``, score the same step-0 and
    trained snapshots on the same cached probe set. Both accuracies are means over the
    same items, so they are equal, but where two scores tie within f32 rounding: one
    flipped item is allowed, one of 6 videos' 8-way caption picks (1/6) or one of the 6
    ordered frame pairs of one of 6 videos (1/36). The random-init rows are
    other draws in each package (JAX keys against torch seeds) and are not compared, nor
    are the fitted probes (BC, linear), which `test_torch_evalsuite.py` holds to the JAX
    package's: both CLIs run with `_metrics_for_split` stubbed, which keeps this short."""
    import jax

    from r3m_tpu.checkpoint import save_snapshot
    from r3m_tpu.models.distilbert import distilbert_init

    copies = {}
    for name in ("port", "jax"):
        copies[name] = str(tmp_path / name)
        shutil.copytree(run, copies[name])
        save_snapshot(os.path.join(copies[name], "bert.npz"),
                      distilbert_init(jax.random.PRNGKey(9)))
    spec = importlib.util.spec_from_file_location("jax_probe_delta", _JAX_SCRIPT)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    for module in (probe_delta, script):
        monkeypatch.setattr(module, "_metrics_for_split",
                            lambda *a, **k: dict.fromkeys(script.METRICS, 0.0))
    assert probe_delta.main(["--run", copies["port"], "--skip-train", *ARGS]) == 0
    monkeypatch.setattr(sys, "argv", [_JAX_SCRIPT, "--run", copies["jax"], "--skip-train",
                                      *SIZES])
    script.main()
    port, jax_rows = (_result(copies[n])["rows"] for n in ("port", "jax"))
    assert [r["encoder"] for r in jax_rows] == ENCODERS
    for got, want in zip(port[1:], jax_rows[1:]):
        for m, one_item in (("reward_order_acc", 1 / 36), ("lang_contrast_acc", 1 / 6)):
            assert abs(got[m] - want[m]) <= one_item + 1e-12, (got["encoder"], m, got[m],
                                                               want[m])
