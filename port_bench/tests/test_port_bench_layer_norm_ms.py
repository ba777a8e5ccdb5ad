"""``layer_norm_ms.serve`` on hand-built traced windows: the kernels under the span
``r3m.layer_norm`` summed a request, and ``None`` for a program without the span (the
parent of the span's change), a window without host ops, or one without device events."""

from __future__ import annotations

import pytest

from port_bench import harness, trace

MAIN = 1


def _kernel(name, start_us, us, ops):
    return trace.DeviceEvent(name, "kernel", start_us * 1000, (start_us + us) * 1000,
                             tuple(ops))


def _window(span="r3m.layer_norm", requests=3, calls=5):
    """`requests` encoder calls, each with `calls` LayerNorm calls of one 30 us kernel
    under `span` and a 70 us product outside it."""
    events, main = [], []
    for request in range(requests):
        t0 = request * 10_000
        main.append((t0 * 1000, (t0 + 9_000) * 1000, "r3m.encoder"))
        for j in range(calls):
            s = t0 + 1000 + 200 * j
            main.append((s * 1000, (s + 40) * 1000, span))
            events.append(_kernel("layer_norm_fwd_kernel", s, 30,
                                  [span, "r3m.encoder.embed", "r3m.encoder"]))
            events.append(_kernel("gemm", s + 50, 70, ["r3m.dense.fused", "r3m.encoder.embed",
                                                       "r3m.encoder"]))
    win = trace.Window(1.0, events, 0.0, [], {MAIN: sorted(main)})
    return harness.Context({}, {}, requests, 1.0, {}, {}, None, requests, win)


@pytest.fixture
def reader():
    return harness.load_module("layer_metrics", "layer_norm_ms.serve")


def test_kernels_under_the_span_are_summed_a_request(reader):
    assert reader.read(_window()) == pytest.approx(5 * 0.03)
    assert reader.read(_window(requests=2, calls=81)) == pytest.approx(81 * 0.03)


def test_a_program_without_the_span_reads_none(reader):
    """The parent's LayerNorm runs as ATen ops under no span of its own."""
    assert reader.read(_window(span="aten::mean")) is None


def test_a_window_without_host_ops_or_device_events_reads_none(reader):
    assert reader.read(harness.Context({}, {}, 2, 1.0, {}, {}, None, 0, None)) is None
    ctx = _window()
    ctx.ops.events = []
    assert reader.read(ctx) is None
