"""``remat="conv_saved"`` in the port: the ResNet train forward that keeps convolution
outputs and BatchNorm moments for the backward and recomputes the normalise and the ReLUs
(`r3m_tpu_torch.models.resnet.ResNet._forward_conv_saved`), on the CPU.

Against the JAX step with the same remat (ResNet-18, 32 px, f32, rctraj, language on;
the JAX conv_saved step is bit-equal to its remat="none" step), at the train step's
tolerances: loss and metrics rtol 1e-4, gradient leaves relative L2 1e-3, BatchNorm
statistics rtol 1e-4 (``tests/test_torch_train_step.py`` says why), at grad_accum 1 and 2,
and at two gloo ranks against the JAX mesh step. The JAX gradients are its Adam first
moment over 0.1 after one step.

Against the port's own remat="none" step: not bit-equal, since "none" runs torch's fused
BatchNorm and conv_saved the JAX form (``E[y^2] - E[y]^2`` in f32); the loss agrees to rtol
1e-5, the gradient leaves to relative L2 1e-4 and the statistics to rtol 1e-5 at these
shapes. The running statistics move once a step: a second update would move them by 0.9
of the first update's distance, far outside that tolerance.
"""

import copy
import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

import jax

from r3m_tpu.models.r3m import R3MConfig as JaxR3MConfig
from r3m_tpu_torch.models.r3m import R3MConfig, r3m_embed, r3m_init
from r3m_tpu_torch.models.resnet import ResNet
from r3m_tpu_torch.training.trainer import make_train_step
from tests.test_torch_parallel import Setup as ParallelSetup
from tests.test_torch_parallel import _matches_jax
from tests.test_torch_train_step import CLIPS, Setup, _assert_bn_stats, _assert_metrics, \
    _batch, _draws

RTOL_NONE = 1e-5
GRAD_REL_L2_NONE = 1e-4


@pytest.fixture(autouse=True)
def _remove_tmp_path(tmp_path):
    """Each test's temporary directory goes when the test ends: the suite's files add up."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def resnet():
    s = Setup(18, 32)
    s.jcfg = dataclasses.replace(s.jcfg, remat="conv_saved")
    s.cfg = dataclasses.replace(s.cfg, remat="conv_saved")
    return s


def _jax_grads_from_adam(s, jstate1):
    """The JAX step's gradients: Adam's first moment after one step is 0.1 times them."""
    return jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1, jstate1.opt_state[0].mu)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_conv_saved_step_matches_jax(resnet, grad_accum):
    s = resnet
    batch = _batch(np.random.default_rng(3 if grad_accum == 1 else 1))
    _, rects, perms, _ = _draws(s.jstate.key, CLIPS, grad_accum, s.cfg.num_negatives)
    jstate1, jm = s.jax_step(grad_accum)(s.jstate, batch)

    state = s.port_state()
    step = make_train_step(s.cfg, s.bert, doaug="rctraj", grad_accum=grad_accum,
                           device="cpu")
    state, m = step(state, batch, perms=perms if grad_accum > 1 else perms[0],
                    crops=torch.from_numpy(rects))
    _assert_metrics(m, jm)
    s.assert_grads(state.model, _jax_grads_from_adam(s, jstate1))
    _assert_bn_stats(state.model, jstate1.params, jstate1.batch_stats, s.size)


def _step_both(s, batch, perms, rects):
    """One port step from the same state with remat "none" and "conv_saved"."""
    out = {}
    for remat in ("none", "conv_saved"):
        cfg = dataclasses.replace(s.cfg, remat=remat)
        state = s.port_state()
        stats0 = {k: v.clone() for k, v in state.batch_stats.items()}
        state, m = make_train_step(cfg, s.bert, doaug="rctraj", device="cpu")(
            state, batch, perms=perms, crops=torch.from_numpy(rects))
        out[remat] = (m, {n: p.grad.clone() for n, p in state.model.named_parameters()},
                      state.batch_stats, stats0)
    return out


def test_conv_saved_matches_none_and_moves_statistics_once(resnet):
    s = resnet
    batch = _batch(np.random.default_rng(3))
    _, rects, perms, _ = _draws(s.jstate.key, CLIPS, 1, s.cfg.num_negatives)
    out = _step_both(s, batch, perms[0], rects)
    (m0, g0, st0, before), (m1, g1, st1, _) = out["none"], out["conv_saved"]
    for k in m0:
        np.testing.assert_allclose(float(m1[k]), float(m0[k]), rtol=RTOL_NONE, atol=1e-8,
                                   err_msg=k)
    floor = 1e-4 * torch.linalg.vector_norm(torch.stack([g.norm() for g in g0.values()]))
    for n, g in g0.items():
        err = (g1[n] - g).norm() / torch.maximum(g.norm(), floor)
        assert err <= GRAD_REL_L2_NONE, f"{n}: relative L2 {err}"
    assert st0  # ResNet-18: 20 BatchNorm layers, a mean and a variance each
    for k, once in st0.items():
        torch.testing.assert_close(st1[k], once, rtol=RTOL_NONE, atol=1e-7)
        twice = once + 0.9 * (once - before[k])  # a second momentum update, same batch
        assert not torch.allclose(twice, once, rtol=RTOL_NONE, atol=1e-7), k


def _saved_activation_bytes(net, x, remat):
    """Bytes of the storages autograd keeps for the backward of one train forward,
    parameters left out (both modes keep them)."""
    params = {p.untyped_storage().data_ptr() for p in net.parameters()}
    saved = {}

    def pack(t):
        storage = t.untyped_storage()
        if storage.data_ptr() not in params:
            saved[storage.data_ptr()] = storage.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        net(x, train=True, remat=remat)
    return sum(saved.values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_saved_keeps_fewer_activations(dtype):
    """The memory lever on the CPU: ResNet-50 at 64 px keeps fewer saved-tensor bytes with
    conv_saved (the post-BatchNorm/ReLU copies are recomputed, not kept)."""
    torch.manual_seed(0)
    net = ResNet(50).to(memory_format=torch.channels_last)
    x = torch.randn(4, 3, 64, 64).contiguous(memory_format=torch.channels_last).to(dtype)
    none = _saved_activation_bytes(copy.deepcopy(net), x, "none")
    conv_saved = _saved_activation_bytes(copy.deepcopy(net), x, "conv_saved")
    assert conv_saved < 0.9 * none, (conv_saved, none)


class _RematParallelSetup(ParallelSetup):
    def __init__(self, tmp):
        super().__init__(tmp)
        self.cfg_kw = {**self.cfg_kw, "remat": "conv_saved"}
        self.jcfg = JaxR3MConfig(**self.cfg_kw)


def test_conv_saved_dp_step_matches_jax_mesh_with_the_same_collectives(tmp_path):
    """Two gloo ranks with conv_saved against the JAX mesh step with conv_saved; the
    collectives a step (calls and bytes by kind) are those of the remat="none" step: the
    backward issues no BatchNorm all-reduce again."""
    remat = _RematParallelSetup(str(tmp_path / "conv_saved"))
    os.makedirs(remat.tmp)
    ranks = remat.port_train(2, 1)
    assert _matches_jax(remat, ranks, 2, 1) == []
    plain = ParallelSetup(str(tmp_path / "none"))
    os.makedirs(plain.tmp)
    plain_ranks = plain.port_train(2, 1)
    for r, p in zip(ranks, plain_ranks):
        assert r["tally"] == p["tally"]
        assert sorted(r["collectives"]) == sorted(p["collectives"])


def test_unknown_remat_mode_raises():
    cfg = R3MConfig(size=18, image_size=32, remat="blocks")
    model = r3m_init(cfg)
    obs = torch.zeros(2, 32, 32, 3)
    for train in (True, False):
        with pytest.raises(ValueError, match="blocks"):
            r3m_embed(cfg, model.convnet, obs, train=train)
    with pytest.raises(ValueError, match="remat"):
        R3MConfig(size=0, remat="conv_saved")


def test_conv_saved_eval_forward_is_the_eval_forward():
    """remat changes only what the train forward keeps: in eval mode conv_saved runs the
    same forward as none, bit for bit."""
    cfg = R3MConfig(size=18, image_size=32)
    model = r3m_init(cfg)
    obs = torch.from_numpy(np.random.default_rng(0).uniform(0, 255, (2, 32, 32, 3))
                           .astype(np.float32))
    want = r3m_embed(cfg, model.convnet, obs)
    got = r3m_embed(dataclasses.replace(cfg, remat="conv_saved"), model.convnet, obs)
    assert torch.equal(got, want)
