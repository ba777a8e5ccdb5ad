"""The port's spans (`r3m_tpu_torch.utils.profiling.span`) on the CPU: absent, and free of
work, with no profiler recording; under ``torch.profiler``, the train step's six phases
partition the step, the serving encoder shows its check, copy and forward, and the ViT's
``dense`` one epilogue a call; and what the program computes is the same bit for bit with
the profiler on or off. Small shapes: ResNet-18 and ViT-B/32 at 64 px, a DistilBERT of
one narrow layer, 4 clips of 5 frames. Nothing is written to disk."""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from r3m_tpu_torch.models.distilbert import DistilBert, DistilBertConfig
from r3m_tpu_torch.models.r3m import R3MConfig, R3MEncoder, r3m_init
from r3m_tpu_torch.training.trainer import create_train_state, make_train_step
from r3m_tpu_torch.utils import profiling
from r3m_tpu_torch.utils.profiling import span

CLIPS, TOKENS, SIZE = 4, 8, 64
BERT = DistilBertConfig(vocab_size=100, dim=32, n_layers=1, n_heads=2, hidden_dim=64,
                        max_position_embeddings=64)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    mask = np.ones((CLIPS, TOKENS), np.int32)
    mask[1, 5:] = 0
    return {
        "images": torch.from_numpy(rng.integers(0, 256, (CLIPS, 5, SIZE, SIZE, 3))
                                   .astype(np.uint8)),
        "token_ids": torch.from_numpy(rng.integers(0, 100, (CLIPS, TOKENS)).astype(np.int64)),
        "attn_mask": torch.from_numpy(mask),
        "lang_mask": torch.tensor([1.0, 1.0, 0.0, 1.0]),
    }


@pytest.fixture(scope="module")
def resnet():
    cfg = R3MConfig(size=18, image_size=SIZE, langweight=1.0, lang_dim=BERT.dim,
                    hidden_dim=64)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)
        bert = DistilBert(BERT)
    return cfg, r3m_init(cfg, 0), bert


def _state(resnet):
    cfg, model, _ = resnet
    return create_train_state(cfg, 0, model=copy.deepcopy(model), device="cpu")


def _profiled(fn):
    """`fn()` under a CPU profiler: ``(result, [(name, start_ns, end_ns, thread), ...])``
    of the host ops and ranges it recorded."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    events = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CPU:
            events.append((ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns(),
                           ev.start_thread_id()))
    return out, events


def _named(events, name):
    return [e for e in events if e[0] == name]


def _inside(op, rng):
    return op[3] == rng[3] and rng[1] <= op[1] and op[2] <= rng[2]


def test_without_a_profiler_span_is_the_shared_null_context(resnet, monkeypatch):
    assert not torch.autograd.profiler._is_profiler_enabled
    assert all(span(name) is profiling._OFF for name in profiling.SPANS)
    assert len(set(profiling.SPANS)) == len(profiling.SPANS)

    def recorded(name):
        raise AssertionError(f"{name} recorded with no profiler on")

    monkeypatch.setattr(profiling, "_RecordFunctionFast", recorded)
    cfg, _, bert = resnet
    make_train_step(cfg, bert, doaug="rctraj", device="cpu")(_state(resnet), _batch())
    enc = R3MEncoder(R3MConfig(size=18, image_size=SIZE), device="cpu")
    enc(torch.zeros(1, 3, SIZE, SIZE, dtype=torch.uint8))


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_the_step_phases_partition_the_step(resnet, grad_accum):
    cfg, _, bert = resnet
    step = make_train_step(cfg, bert, doaug="rctraj", grad_accum=grad_accum, device="cpu")
    state, batch = _state(resnet), _batch()
    _, events = _profiled(lambda: step(state, batch))
    (whole,) = _named(events, profiling.STEP)
    phases = [e for e in events if e[0] in profiling.STEP_PHASES]
    counts = {name: len(_named(events, name)) for name in profiling.STEP_PHASES}
    assert counts == {
        profiling.STEP_AUGMENT: 1, profiling.STEP_LANGUAGE: 1,
        profiling.STEP_ENCODE: grad_accum, profiling.STEP_LOSS: grad_accum + 1,
        profiling.STEP_BACKWARD: grad_accum, profiling.STEP_OPTIMIZER: 2}
    assert all(_inside(p, whole) for p in phases)
    ops = [e for e in events if e[0].startswith("aten::") and e[3] == whole[3]]
    assert ops
    for op in ops:
        assert _inside(op, whole), op
        assert sum(_inside(op, p) for p in phases) == 1, op

    def phase_of(name):
        (op,) = [o for o in ops if o[0] == name][:1]
        return next(p[0] for p in phases if _inside(op, p))

    assert phase_of("aten::_foreach_norm") == profiling.STEP_OPTIMIZER
    assert phase_of("aten::embedding") == profiling.STEP_LANGUAGE
    assert phase_of("aten::convolution") == profiling.STEP_ENCODE
    assert phase_of("aten::convolution_backward") == profiling.STEP_BACKWARD


def test_the_step_is_the_same_with_the_profiler_on(resnet):
    cfg, _, bert = resnet
    step = make_train_step(cfg, bert, doaug="rctraj", device="cpu")
    plain, traced = _state(resnet), _state(resnet)
    for seed in (0, 1):
        batch = _batch(seed)
        _, want = step(plain, batch)
        (_, got), _ = _profiled(lambda: step(traced, batch))
        assert want.keys() == got.keys()
        for k in want:
            assert torch.equal(want[k], got[k]), k
    for (name, a), b in zip(plain.model.state_dict().items(),
                            traced.model.state_dict().values()):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("size,precision", [(18, "parity"), (0, "fast")])
def test_the_encoder_shows_its_check_copy_and_forward(size, precision):
    enc = R3MEncoder(R3MConfig(size=size, image_size=SIZE), precision=precision,
                     device="cpu")
    frames = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (2, 3, SIZE, SIZE)).astype(np.uint8))
    want = enc(frames)  # the first call folds the serving weights
    got, events = _profiled(lambda: enc(frames))
    assert torch.equal(want, got)
    (whole,) = _named(events, profiling.ENCODER)
    children = {}
    for name in (profiling.ENCODER_CHECK, profiling.ENCODER_H2D, profiling.ENCODER_EMBED):
        (children[name],) = _named(events, name)
        assert _inside(children[name], whole), name
    check = children[profiling.ENCODER_CHECK]
    assert not [e for e in events if e[0].startswith("aten::") and _inside(e, check)]
    epilogues = _named(events, profiling.DENSE_EPILOGUE)
    if size == 0:  # q, k, v, the attention's output, the MLP's two a layer, the pooler
        layers = len(enc.convnet.encoder.layer)
        assert len(epilogues) == 6 * layers + 1
        embed = children[profiling.ENCODER_EMBED]
        assert all(_inside(e, embed) for e in epilogues)
    else:
        assert not epilogues


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_shows_one_epilogue_a_call(dtype):
    from r3m_tpu_torch.models.layers import dense

    g = torch.Generator().manual_seed(3)
    x = torch.randn(6, 16, generator=g).to(dtype)
    w, b = torch.randn(8, 16, generator=g), torch.randn(8, generator=g)
    want = [dense(x, w, b) for _ in range(3)]
    got, events = _profiled(lambda: [dense(x, w, b) for _ in range(3)])
    assert all(torch.equal(a, c) for a, c in zip(want, got))
    epilogues = _named(events, profiling.DENSE_EPILOGUE)
    assert len(epilogues) == 3
    adds = [e for e in events if e[0] == "aten::add"]
    assert adds and all(any(_inside(a, e) for e in epilogues) for a in adds)


def test_spans_are_host_ops():
    """A span is recorded as a host op, as aten's are: not as a user annotation, which
    CUDA traces copy onto the device's timeline under the range's own id."""
    from r3m_tpu_torch.models.layers import dense

    x, w, b = torch.ones(2, 4), torch.ones(3, 4), torch.zeros(3)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        dense(x, w, b)
    kinds = {str(ev.activity_type()) for ev in prof.profiler.kineto_results.events()
             if ev.name() == profiling.DENSE_EPILOGUE}
    assert kinds == {"cpu_op"}
