"""`R3MEncoder`'s CUDA graphs of its small-batch ResNet forward.

On the CPU an eager stand-in takes the place of the capture (`graphs.capture`), and the
rule is told that the CPU is a CUDA device: the tests hold where a graph engages, the
first-eager / capture / replay order, one entry a key and the eviction of the least
recently used, the refold's drop of every graph, the fallback of a capture that raises,
the fresh tensor a call returns, and K1's launch counter. The tests marked ``cuda``
capture real graphs on the card and skip without one. This file imports no JAX, so it
runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_serving_graphs.py
"""

import copy
import warnings

import numpy as np
import pytest
import torch

from r3m_tpu_torch.models import graphs
from r3m_tpu_torch.models.r3m import R3MConfig, R3MEncoder, r3m_init
from r3m_tpu_torch.ops import image, pool
from r3m_tpu_torch.parallel.mesh import make_mesh

CFG = R3MConfig(size=18, image_size=32)


class Recorder:
    """An eager stand-in for `graphs.capture`: the capture runs the forward once and a
    replay runs it again into the static output, leaving K1's launch counter as a graph's
    replay leaves it (a replay runs no Python). With `fail`, the capture raises."""

    def __init__(self, fail=False):
        self.calls, self.fail = [], fail

    def __call__(self, fn, static_in):
        self.calls.append("capture")
        if self.fail:
            raise RuntimeError("operation not permitted when stream is capturing")
        static_out = fn(static_in)

        def replay():
            self.calls.append("replay")
            launches = pool.maxpool_3x3s2_fwd.launches
            static_out.copy_(fn(static_in))
            pool.maxpool_3x3s2_fwd.launches = launches

        return replay, static_out


@pytest.fixture
def recorder(monkeypatch):
    """The stand-in capture, with the CPU taken for a CUDA device by the rule."""
    rec = Recorder()
    rule = graphs.engages
    monkeypatch.setattr(graphs, "engages",
                        lambda owns, device, batch: rule(owns, torch.device("cuda", 0), batch))
    monkeypatch.setattr(graphs, "capture", rec)
    return rec


def _frames(n=1, hw=32, seed=0, dtype=torch.uint8):
    x = np.random.default_rng(seed).integers(0, 256, (n, 3, hw, hw), dtype=np.uint8)
    return torch.from_numpy(x).to(dtype)


def _encoder(cfg=CFG, **kw):
    torch.manual_seed(0)
    return R3MEncoder(cfg, device="cpu", **kw)


@pytest.mark.parametrize("owns,device,batch,want", [
    (True, "cuda:0", 1, True), (True, "cuda:0", 16, True), (True, "cuda:1", 4, True),
    (True, "cuda:0", 17, False), (True, "cpu", 1, False), (False, "cuda:0", 1, False)])
def test_the_rule(owns, device, batch, want):
    assert graphs.engages(owns, torch.device(device), batch) is want


@pytest.mark.parametrize("case", ["resnet", "vit", "mesh", "batch17", "cpu"])
def test_where_the_encoder_engages(monkeypatch, case):
    """A ResNet on one device at batch <= 16 engages; the ViT (the caller's own module), a
    mesh, batch 17 and a true CPU device (the rule unpatched) stay eager."""
    rec = Recorder()
    monkeypatch.setattr(graphs, "capture", rec)
    if case != "cpu":
        rule = graphs.engages
        monkeypatch.setattr(graphs, "engages", lambda owns, device, batch: rule(
            owns, torch.device("cuda", 0), batch))
    if case == "vit":
        enc = _encoder(R3MConfig(size=0, image_size=32))
    elif case == "mesh":
        enc = _encoder(mesh=make_mesh(devices=["cpu", "cpu"]))
    else:
        enc = _encoder()
    x = _frames(17 if case == "batch17" else 2)
    outs = [enc(x) for _ in range(3)]
    engaged = case == "resnet"
    assert (enc.graph_captures, enc.graph_replays) == ((1, 2) if engaged else (0, 0))
    assert rec.calls == (["capture", "replay", "replay"] if engaged else [])
    for out in outs[1:]:
        assert torch.equal(out, outs[0])


def test_first_call_eager_then_capture_then_replays(recorder):
    enc = _encoder()
    x = _frames(4)
    seen = []
    for _ in range(4):
        out = enc(x)
        seen.append((enc.graph_captures, enc.graph_replays, list(recorder.calls)))
    assert seen == [(0, 0, []), (1, 1, ["capture", "replay"]),
                    (1, 2, ["capture", "replay", "replay"]),
                    (1, 3, ["capture", "replay", "replay", "replay"])]
    assert torch.equal(out, _encoder()(x))


def test_one_entry_a_key_and_the_least_recently_used_out_past_four(recorder):
    enc = _encoder()
    keys = [_frames(b) for b in (1, 2, 3)] + [_frames(3, dtype=torch.float32), _frames(5)]
    for x in keys:  # five keys: batch, and dtype at batch 3
        enc(x), enc(x)
    assert enc.graph_captures == 5 and len(enc._graphs.entries) == graphs.MAX_KEYS
    assert [k[0][0] for k in enc._graphs.entries] == [2, 3, 3, 5]
    enc(keys[1])  # the oldest left is now the newest
    assert [k[0][0] for k in enc._graphs.entries] == [3, 3, 5, 2]
    enc(keys[0])  # evicted: its first call again, eager, which evicts batch 3 uint8
    assert enc.graph_captures == 5
    assert [(k[0][0], k[1]) for k in enc._graphs.entries] == [
        (3, torch.float32), (5, torch.uint8), (2, torch.uint8), (1, torch.uint8)]
    assert torch.equal(enc(keys[0]), _encoder()(keys[0])) and enc.graph_captures == 6


@pytest.mark.parametrize("change", ["refold", "bn_weight_in_place", "load_state_dict"])
def test_a_refold_drops_every_graph(recorder, change):
    """A refold, called or forced by an edit of the weights, drops every graph; the next
    call of a key runs eagerly on the new weights and the one after captures them."""
    enc = _encoder()
    x, y = _frames(1), _frames(2, seed=1)
    for _ in range(2):
        enc(x), enc(y)
    assert enc.graph_captures == 2 and len(enc._graphs.entries) == 2
    other = r3m_init(CFG, seed=1).convnet
    if change == "refold":
        enc.refold()
        assert not enc._graphs.entries
    elif change == "bn_weight_in_place":
        with torch.no_grad():
            enc.convnet.layer4[1].bn2.weight.mul_(1.5)
    else:
        enc.convnet.load_state_dict(other.state_dict())
    want = R3MEncoder(CFG, enc.convnet.state_dict(), device="cpu")(x)
    assert torch.equal(enc(x), want) and enc.graph_captures == 2
    assert list(enc._graphs.entries.values()) == [None]
    assert torch.equal(enc(x), want) and enc.graph_captures == 3
    assert enc._graphs.entries[(tuple(x.shape), x.dtype, "parity")].weights is enc._replicas[0]


def test_a_capture_that_raises_falls_back_for_good(recorder):
    recorder.fail = True
    enc = _encoder()
    x = _frames(2)
    want = enc(x)
    with pytest.warns(UserWarning, match="runs eagerly"):
        got = enc(x)
    assert torch.equal(got, want) and enc.graph_fallbacks == 1
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(3):
            assert torch.equal(enc(x), want)
    assert not [w for w in caught if "runs eagerly" in str(w.message)]
    assert recorder.calls == ["capture"] and enc.graph_fallbacks == 1
    assert (enc.graph_captures, enc.graph_replays) == (0, 0)
    recorder.fail = False  # another key still captures
    y = _frames(1)
    enc(y), enc(y)
    assert enc.graph_captures == 1


def test_a_call_returns_a_fresh_tensor(recorder):
    """Embeddings a caller keeps from one call stay as they were after the next."""
    enc = _encoder()
    x, y = _frames(1, seed=0), _frames(1, seed=1)
    want_x, want_y = _encoder()(x), _encoder()(y)
    enc(x), enc(x)
    a = enc(x)
    b = enc(y)
    static = enc._graphs.entries[(tuple(x.shape), x.dtype, "parity")].static_out
    assert a.data_ptr() != static.data_ptr() and b.data_ptr() != static.data_ptr()
    assert torch.equal(a, want_x) and torch.equal(b, want_y) and not torch.equal(a, b)
    with torch.inference_mode():  # the encoder's outputs are inference tensors
        b.add_(1.0)
    assert torch.equal(enc(y), want_y)


def test_k1_counts_once_a_replay(recorder, monkeypatch):
    """K1's counter counts launches that ran: the eager call's, the capturing call's
    replay and each replay's, but not the launch the capture recorded."""
    plain = pool.maxpool_3x3s2_reference

    def counted(x):  # the CPU's plain version, counted as the card's kernel is
        pool.maxpool_3x3s2_fwd.launches += 1
        return plain(x)

    monkeypatch.setattr(pool, "maxpool_3x3s2_reference", counted)
    enc = _encoder()
    x = _frames(2)
    before = pool.maxpool_3x3s2_fwd.launches
    counts = []
    for _ in range(4):
        enc(x)
        counts.append(pool.maxpool_3x3s2_fwd.launches - before)
    assert counts == [1, 2, 3, 4]


def test_normalize_makes_its_constants_once_and_autograd_may_save_them():
    """A capture admits no copy from the host: the constants are made once, and those
    made inside inference mode still serve a forward that autograd records."""
    x = torch.rand(2, 4, 4, 3)
    with torch.inference_mode():
        first = image.normalize(x, image.IMAGENET_MEAN, image.IMAGENET_STD)
    hits = image._channel_stats.cache_info().hits
    leaf = x.clone().requires_grad_()
    out = image.normalize(leaf, list(image.IMAGENET_MEAN), list(image.IMAGENET_STD))
    assert image._channel_stats.cache_info().hits == hits + 1
    assert torch.equal(out.detach(), first)
    out.sum().backward()
    torch.testing.assert_close(leaf.grad[0, 0, 0], 1 / torch.tensor(image.IMAGENET_STD))


def test_a_copy_of_the_encoder_starts_without_graphs(recorder):
    enc = _encoder()
    x = _frames(1)
    enc(x), enc(x)
    twin = copy.deepcopy(enc)
    assert not twin._graphs.entries and twin._graphs.lock is not enc._graphs.lock
    assert torch.equal(twin(x), enc(x))


# ---- on the card ----------------------------------------------------------------------

R50 = R3MConfig(size=50)
SIZES = {"224": (224, 224), "256x320": (256, 320)}


@pytest.fixture(scope="module")
def r50_state():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs capture only there")
    return r3m_init(R50, seed=0).convnet.state_dict()


@pytest.fixture(scope="module")
def r50(r50_state):
    return {p: R3MEncoder(R50, r50_state, precision=p) for p in ("parity", "fast")}


def _card_frames(n, hw, seed=0, dtype=torch.uint8):
    x = np.random.default_rng(seed).integers(0, 256, (n, 3, *hw), dtype=np.uint8)
    return torch.from_numpy(x).to(dtype)


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32], ids=["uint8", "float"])
@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("batch", [1, 16])
@pytest.mark.parametrize("precision", ["parity", "fast"])
def test_graphed_matches_eager_on_the_card(r50, precision, batch, size, dtype):
    """The replayed graph runs the eager forward's kernels: the same embeddings (to 1e-6
    of the largest, bit for bit expected), and K1 counted once a replay."""
    enc = r50[precision]
    enc.refold()
    x = _card_frames(batch, SIZES[size], dtype=dtype)
    captures, replays = enc.graph_captures, enc.graph_replays
    k1 = pool.maxpool_3x3s2_fwd.launches
    eager = enc(x)
    assert enc.graph_captures == captures
    got = [enc(x), enc(x)]
    assert (enc.graph_captures, enc.graph_replays) == (captures + 1, replays + 2)
    assert pool.maxpool_3x3s2_fwd.launches - k1 == 1 + graphs.WARMUP + 2
    for g in got:
        assert g.shape == (batch, 2048) and g.dtype == torch.float32
        assert _rel(g, eager) <= 1e-6


@pytest.mark.cuda
def test_an_in_place_bn_edit_recaptures_on_the_card(r50, r50_state):
    enc = R3MEncoder(R50, r50_state)
    x = _card_frames(1, (224, 224))
    for _ in range(3):
        enc(x)
    assert enc.graph_captures == 1
    with torch.no_grad():
        enc.convnet.layer4[2].bn3.weight.mul_(1.5)
        enc.convnet.layer1[0].bn1.weight.add_(0.25)
    want = R3MEncoder(R50, enc.convnet.state_dict())(x)
    for _ in range(3):
        assert _rel(enc(x), want) <= 1e-6
    assert enc.graph_captures == 2 and enc.graph_replays == 4


@pytest.mark.cuda
def test_kept_embeddings_stay_distinct_on_the_card(r50_state):
    enc = R3MEncoder(R50, r50_state)
    x, y = _card_frames(1, (224, 224), seed=1), _card_frames(1, (224, 224), seed=2)
    want_x, want_y = enc(x), R3MEncoder(R50, r50_state)(y)  # both eager, first calls
    enc(x)
    a = enc(x)
    b = enc(y)
    assert enc.graph_replays == 3
    torch.cuda.synchronize()
    assert _rel(a, want_x) <= 1e-6 and _rel(b, want_y) <= 1e-6
    assert _rel(a, b) > 1e-3


@pytest.mark.cuda
def test_batch_64_runs_eagerly_on_the_card(r50_state):
    enc = R3MEncoder(R50, r50_state)
    x = _card_frames(64, (224, 224))
    outs = [enc(x) for _ in range(3)]
    assert (enc.graph_captures, enc.graph_replays) == (0, 0)
    assert not enc._graphs.entries
    assert all(torch.equal(o, outs[0]) for o in outs)
