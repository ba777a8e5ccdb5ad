"""``graph_share.latency`` on hand-built traced windows: replay ranges over the forwards'
ranges, whole when a profiler event took a replay's id, and ``None`` for a program that
has no replay span or a window without the encoder's forwards."""

from __future__ import annotations

import pytest

from port_bench import harness, trace
from r3m_tpu_torch.utils import profiling

MAIN, OTHER = 1, 2


def _ctx(host_ops):
    win = trace.Window(1.0, [], 0.0, [], host_ops)
    return harness.Context({}, {}, 4, 1.0, {}, {}, None, 4, win)


def _requests(replayed):
    """One encoder call a millisecond, each with its check and copy, and with a replay
    where `replayed` says so, else an eager forward."""
    ops = []
    for i, graph in enumerate(replayed):
        t = i * 1_000_000
        ops += [(t, t + 900_000, "r3m.encoder"), (t + 1, t + 100, "r3m.encoder.check"),
                (t + 200, t + 300, "r3m.encoder.h2d"),
                (t + 400, t + 800, "r3m.encoder.replay" if graph else "r3m.encoder.embed")]
    return ops


@pytest.fixture
def reader():
    return harness.load_module("layer_metrics", "graph_share.latency")


@pytest.mark.parametrize("replayed,want", [
    ((True, True, True, True), 100.0), ((False, True, True, True), 75.0),
    ((False, False), 0.0)])
def test_replays_over_forwards(reader, replayed, want):
    assert reader.read(_ctx({MAIN: _requests(replayed)})) == pytest.approx(want)


def test_every_thread_counts(reader):
    ctx = _ctx({MAIN: _requests((True, False)), OTHER: _requests((True, True))})
    assert reader.read(ctx) == pytest.approx(75.0)


def test_a_replay_range_lost_to_a_profiler_event_leaves_the_share_whole(reader):
    """The reduction keeps one host op an id; a profiler event that reuses a replay
    range's id takes its place."""
    ops = _requests((True,) * 4)
    lost = ops.index((3_000_400, 3_000_800, "r3m.encoder.replay"))
    ops[lost] = (3_000_500, 3_000_510, "Activity Buffer Request")
    assert reader.read(_ctx({MAIN: ops})) == pytest.approx(100.0)


def test_a_program_without_the_span_reads_none(reader, monkeypatch):
    spans = tuple(s for s in profiling.SPANS if s != "r3m.encoder.replay")
    monkeypatch.setattr(profiling, "SPANS", spans)
    assert reader.read(_ctx({MAIN: _requests((False, False))})) is None


def test_a_window_without_the_encoder_reads_none(reader):
    assert reader.read(_ctx({MAIN: [(0, 10, "r3m.step")]})) is None
    assert reader.read(harness.Context({}, {}, 0, 1.0, {}, {})) is None
