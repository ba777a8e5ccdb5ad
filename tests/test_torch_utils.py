"""The port's utility helpers against the JAX package's, on the CPU.

`soft_update_params`, `accuracy`, `schedule` and `instantiate` are deterministic and
match the JAX functions exactly (`schedule` to f32 rounding between the ends, which JAX
computes in f32 and the port in f64, and exactly at the ends). `eval_mode` is the
reference's context over `nn.Module`s. The two random initialisers cannot share JAX's
draws: their shape, dtype, bounds and orthogonality are held, and one generator seed
gives one draw. The op profile of a torch trace is held on a synthetic Chrome trace
whose rows are worked out by hand, on a real CPU trace (no device events, no rows) and
on a missing directory.
"""

import collections
import json
import os
import shutil

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from r3m_tpu.utils import config as jconfig
from r3m_tpu.utils import misc as jmisc
from r3m_tpu.utils import profiling as jprofiling
from r3m_tpu_torch.utils import config, misc, profiling


@pytest.fixture(autouse=True)
def _remove_tmp_path(tmp_path):
    """Each test's temporary directory goes when the test ends: the suite's files add up."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _tree(rng):
    return {"conv": rng.normal(size=(3, 4)).astype(np.float32),
            "blocks": [rng.normal(size=5).astype(np.float32),
                       (rng.normal(size=(2, 2)).astype(np.float32),)]}


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


@pytest.mark.parametrize("tau", [0.005, 0.5, 1.0])
def test_soft_update_params_equals_jax_bit_for_bit(tau):
    rng = np.random.default_rng(0)
    net, target = _tree(rng), _tree(rng)
    as_torch = lambda t: jax.tree_util.tree_map(torch.from_numpy, t)  # noqa: E731
    net_t, target_t = as_torch(net), as_torch(target)
    got = misc.soft_update_params(net_t, target_t, tau)
    want = jmisc.soft_update_params(jax.tree_util.tree_map(jnp.asarray, net),
                                    jax.tree_util.tree_map(jnp.asarray, target), tau)
    assert isinstance(got["blocks"], list) and isinstance(got["blocks"][1], tuple)
    assert len(_leaves(got)) == len(_leaves(want)) == 3
    for g, w in zip(_leaves(got), _leaves(want)):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for before, after in zip(_leaves(net), _leaves(net_t)):  # the inputs stay as they were
        np.testing.assert_array_equal(before, after.numpy())


def test_accuracy_with_ties_equals_jax():
    """Logits drawn from three values, so most rows tie: a stable ranking of -logits picks
    the lower class first in both packages."""
    rng = np.random.default_rng(1)
    logits = rng.integers(0, 3, (64, 10)).astype(np.float32)
    target = rng.integers(0, 10, 64)
    got = misc.accuracy(torch.from_numpy(logits), torch.from_numpy(target), (1, 2, 5))
    want = jmisc.accuracy(jnp.asarray(logits), jnp.asarray(target), (1, 2, 5))
    assert [float(g) for g in got] == [float(w) for w in want]
    assert 0.0 < float(got[0]) < float(got[1]) < float(got[2]) < 1.0
    tied = misc.accuracy(torch.tensor([[1.0, 1.0, 0.0]]), torch.tensor([1]), (1, 2))
    assert [float(t) for t in tied] == [0.0, 1.0]  # fractions, and class 0 ranks first


SCHEDULES = [
    ("3e-4", 3e-4, 3e-4, 200),
    ("linear(1e-4,1e-5,100)", 1e-4, 1e-5, 100),
    ("step_linear(1e-3,1e-4,50,1e-5,30)", 1e-3, 1e-5, 80),
]


@pytest.mark.parametrize("schdl,first,last,end", SCHEDULES)
def test_schedule_equals_jax(schdl, first, last, end):
    """Steps 0 to past the end, both durations' edges among them."""
    steps = sorted(set(range(0, end + 20, 7)) | {0, 1, 49, 50, 51, 79, 80, 81, 99, 100, 101})
    got = np.array([misc.schedule(schdl, s) for s in steps])
    want = np.array([jmisc.schedule(schdl, s) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert isinstance(misc.schedule(schdl, 3), float)
    for step, value in ((0, first), (end, last), (end + 50, last)):
        assert misc.schedule(schdl, step) == value
        assert np.float32(misc.schedule(schdl, step)) == np.float32(jmisc.schedule(schdl, step))
    assert misc.schedule(first, 7) == first  # a float, not a string
    assert np.float32(first) == np.float32(jmisc.schedule(first, 7))


def test_schedule_rejects_what_jax_rejects():
    for pkg in (misc, jmisc):
        with pytest.raises(NotImplementedError):
            pkg.schedule("cosine(1e-4,0,10)", 0)


def test_instantiate_builds_what_jax_builds():
    node = {"_target_": "collections.OrderedDict", "a": 1, "b": 2}
    got = config.instantiate(node, b=3, c=4)
    want = jconfig.instantiate(node, b=3, c=4)
    assert type(got) is type(want) is collections.OrderedDict
    assert list(got.items()) == list(want.items()) == [("a", 1), ("b", 3), ("c", 4)]
    assert node == {"_target_": "collections.OrderedDict", "a": 1, "b": 2}
    with pytest.raises(ModuleNotFoundError):
        config.instantiate({"_target_": "no_such_package.Thing"})


def test_eval_mode_restores_every_flag_and_accepts_anything():
    model = nn.Sequential(nn.Linear(4, 4), nn.Dropout(0.5), nn.BatchNorm1d(4))
    model[1].eval()  # one submodule already in eval mode: it stays so on exit
    other = nn.Linear(2, 2).eval()
    before = [m.training for m in model.modules()]
    with misc.eval_mode(model, other, "anything") as ctx:
        assert isinstance(ctx, misc.eval_mode)
        assert not any(m.training for m in (*model.modules(), other))
    assert [m.training for m in model.modules()] == before == [True, True, False, True]
    assert not other.training
    with pytest.raises(ValueError):
        with misc.eval_mode(model):
            raise ValueError("raised inside")
    assert [m.training for m in model.modules()] == before
    with jmisc.eval_mode("anything"), misc.eval_mode("anything"):
        pass


@pytest.mark.parametrize("shape", [(3, 5), (5, 3), (4, 4), (8, 2, 3, 3)])
@pytest.mark.parametrize("gain", [1.0, 2.0])
def test_orthogonal_init_is_orthogonal(shape, gain):
    """``shape[0]`` against the rest: the short side's Gram matrix is gain^2 I, as the JAX
    initialiser's is over its own layout."""
    w = misc.orthogonal_init(shape, gain, generator=torch.Generator().manual_seed(0))
    assert w.shape == shape and w.dtype == torch.float32
    flat = w.reshape(shape[0], -1).double()
    gram = flat @ flat.T if flat.shape[0] <= flat.shape[1] else flat.T @ flat
    np.testing.assert_allclose(gram.numpy(), gain ** 2 * np.eye(len(gram)), atol=1e-5)
    jw = np.asarray(jmisc.orthogonal_init(jax.random.PRNGKey(0), shape, gain), np.float64)
    jflat = jw.reshape(-1, shape[-1])
    jgram = jflat @ jflat.T if jflat.shape[0] <= jflat.shape[1] else jflat.T @ jflat
    np.testing.assert_allclose(jgram, gain ** 2 * np.eye(len(jgram)), atol=1e-5)
    assert jw.shape == tuple(w.shape)
    same = misc.orthogonal_init(shape, gain, generator=torch.Generator().manual_seed(0))
    other = misc.orthogonal_init(shape, gain, generator=torch.Generator().manual_seed(1))
    assert torch.equal(w, same) and not torch.equal(w, other)
    assert misc.orthogonal_init(shape, gain, torch.bfloat16).dtype == torch.bfloat16


@pytest.mark.parametrize("mean,std,low,high", [(0.0, 1.0, -2.0, 2.0), (0.5, 0.1, -1.0, 3.0)])
def test_truncated_normal_bounds_and_draws(mean, std, low, high):
    """Samples stay in [mean + std*low, mean + std*high]; 100,000 of them have the JAX
    draw's mean and spread to 2% of `std` (both seeded, so the check is fixed)."""
    shape = (100, 1000)
    z = misc.truncated_normal(shape, mean, std, low, high, torch.Generator().manual_seed(0))
    jz = np.asarray(jmisc.truncated_normal(jax.random.PRNGKey(0), shape, mean, std, low, high))
    assert z.shape == shape and z.dtype == torch.float32 and jz.shape == shape
    lo, hi = mean + std * low, mean + std * high
    for draw in (z.numpy(), jz):
        assert lo - 1e-6 <= draw.min() and draw.max() <= hi + 1e-6
    assert abs(z.mean().item() - jz.mean()) < 0.02 * std
    assert abs(z.std().item() - jz.std()) < 0.02 * std
    again = misc.truncated_normal(shape, mean, std, low, high, torch.Generator().manual_seed(0))
    assert torch.equal(z, again)


# ---------------------------------------------------------------------------------------
# the op profile of a torch trace


def _event(name, dur_us, cat="kernel", **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": 100.0,
            "dur": dur_us, "args": args}


def _write_trace(path, events, mtime):
    with open(path, "w") as f:
        json.dump({"schemaVersion": 1, "traceEvents": events}, f)
    os.utime(path, (mtime, mtime))


def test_op_profile_of_a_synthetic_trace(tmp_path):
    """Device events summed by name, heaviest first; host events, flows and the older
    trace beside it are not read."""
    d = tmp_path / "tr"
    (d / "sub").mkdir(parents=True)
    events = [
        _event("maxpool3x3s2_kernel", 2.5),
        _event("sm90_xmma_gemm", 3.0, flops=6e6),
        _event("maxpool3x3s2_kernel", 1.5),
        _event("sm90_xmma_gemm", 1.0, flops=2e6),
        _event("Memcpy HtoD (Pageable -> Device)", 0.25, cat="gpu_memcpy"),
        _event("Memset (Device)", 0.125, cat="gpu_memset"),
        _event("aten::conv2d", 50.0, cat="cpu_op"),
        _event("cudaLaunchKernel", 5.0, cat="cuda_runtime"),
        {"ph": "s", "cat": "ac2g", "name": "ac2g", "id": 1, "ts": 1.0},
    ]
    _write_trace(d / "sub" / "host.2.pt.trace.json", events, 2_000_000_000)
    _write_trace(d / "host.1.pt.trace.json", [_event("older_kernel", 99.0)], 1_000_000_000)

    rows, total = profiling.op_profile_raw(str(d))
    assert rows == [
        (4_000_000, 8e6, 0, 2, "sm90_xmma_gemm"),
        (4_000_000, 0, 0, 2, "maxpool3x3s2_kernel"),
        (250_000, 0, 0, 1, "Memcpy HtoD (Pageable -> Device)"),
        (125_000, 0, 0, 1, "Memset (Device)"),
    ]
    assert total == 8_375_000
    top, top_total = profiling.op_profile_raw(str(d), top=1)
    assert top == rows[:1] and top_total == total

    frac, tf, gb, occ, name = profiling.op_profile_summary(str(d), top=2)[0]
    assert name == "sm90_xmma_gemm" and occ == 2
    assert frac == pytest.approx(4_000_000 / 8_375_000)
    assert tf == pytest.approx(2.0)  # 8e6 flops in 4 us: 2e12 a second
    assert gb == 0.0
    assert profiling.op_profile_summary(str(d), top=2)[1][1] == 0.0


def test_op_profile_of_a_cpu_trace_has_no_rows(tmp_path, capsys):
    d = str(tmp_path / "cpu")
    with profiling.trace(d):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    assert profiling.op_profile_raw(d) == ([], 0)
    assert profiling.op_profile_summary(d) == []
    profiling.print_op_profile(d)
    assert "no device kernels" in capsys.readouterr().out


def test_op_profile_prints_one_line_a_row(tmp_path, capsys):
    d = tmp_path / "tr"
    d.mkdir()
    _write_trace(d / "h.pt.trace.json", [_event("k_a", 3.0), _event("k_b", 1.0)], 1e9)
    profiling.print_op_profile(str(d))
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2 and lines[0].startswith(" 75.0%") and lines[0].endswith("k_a")


def test_op_profile_of_a_missing_directory_raises(tmp_path):
    for pkg in (profiling, jprofiling):
        with pytest.raises(FileNotFoundError):
            pkg.op_profile_summary(str(tmp_path / "nope"))
