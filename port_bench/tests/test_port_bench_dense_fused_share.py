"""``dense_fused_share.serve`` on hand-built traced windows: fused ranges over the ranges
of every ``dense`` call, and ``None`` for a program without the fused span or a window
without ``dense``."""

from __future__ import annotations

import pytest

from port_bench import harness, trace
from r3m_tpu_torch.utils import profiling

MAIN, OTHER = 1, 2


def _ctx(host_ops):
    win = trace.Window(1.0, [], 0.0, [], host_ops)
    return harness.Context({}, {}, 4, 1.0, {}, {}, None, 4, win)


def _layers(fused):
    """One ``dense`` call a 100 us inside one encoder call, fused or unfused as `fused`
    says, each beside the product's own op."""
    ops = [(0, 100 * len(fused) + 10, "r3m.encoder")]
    for i, f in enumerate(fused):
        t = 100 * i + 1
        ops += [(t, t + 10, "aten::mm"),
                (t + 20, t + 60, "r3m.dense.fused" if f else "r3m.dense.epilogue")]
    return ops


@pytest.fixture
def reader():
    return harness.load_module("layer_metrics", "dense_fused_share.serve")


def test_only_fused_calls_read_100(reader):
    assert reader.read(_ctx({MAIN: _layers((True,) * 6)})) == pytest.approx(100.0)


@pytest.mark.parametrize("fused,want", [((True, True, True, False), 75.0),
                                        ((False, True), 50.0), ((False, False), 0.0)])
def test_mixed_calls_read_the_fused_share(reader, fused, want):
    assert reader.read(_ctx({MAIN: _layers(fused)})) == pytest.approx(want)


def test_every_thread_counts(reader):
    ctx = _ctx({MAIN: _layers((True, False)), OTHER: _layers((True, True))})
    assert reader.read(ctx) == pytest.approx(75.0)


def test_a_program_without_the_span_reads_none(reader, monkeypatch):
    spans = tuple(s for s in profiling.SPANS if s != "r3m.dense.fused")
    monkeypatch.setattr(profiling, "SPANS", spans)
    assert reader.read(_ctx({MAIN: _layers((False, False))})) is None


def test_a_window_without_dense_reads_none(reader):
    assert reader.read(_ctx({MAIN: [(0, 10, "r3m.encoder"), (1, 5, "aten::mm")]})) is None
    assert reader.read(harness.Context({}, {}, 0, 1.0, {}, {})) is None
