"""The readers of the program's spans on a hand-built traced window: kernels under each
span are summed a step, the backward's kernels on the autograd engine's thread count
through its op, the check's host time is a median, and a window without the spans (a
program that has none) reads ``None``."""

from __future__ import annotations

import pytest

from port_bench import harness, trace

MAIN, ENGINE = 1, 2
EVALUATE = "autograd::engine::evaluate_function: MulBackward0"
PHASES = ("augment", "language", "encode", "loss", "backward", "optimizer")


def _kernel(name, start_us, us, ops):
    return trace.DeviceEvent(name, "kernel", start_us * 1000, (start_us + us) * 1000,
                             tuple(ops))


def _ctx(events, host_ops, units=2):
    win = trace.Window(1.0, events, 0.0, [], host_ops)
    return harness.Context({}, {}, units, 1.0, {}, {}, None, units, win)


def _train_window(with_spans=True):
    """Two steps; in each, one kernel a phase of (phase index + 1) * 100 us, a second
    backward kernel of 50 us from the engine's thread, and a copy under augment."""
    events, main, engine = [], [], []
    for step in range(2):
        t0 = step * 10_000
        main.append((t0 * 1000, (t0 + 9_000) * 1000, "r3m.step"))
        for i, phase in enumerate(PHASES):
            name = f"r3m.step.{phase}" if with_spans else "r3m.other"
            s = t0 + 1000 * (i + 1)
            main.append((s * 1000, (s + 900) * 1000, name))
            events.append(_kernel(f"k_{phase}", s, (i + 1) * 100,
                                  ["aten::mul", name, "r3m.step"]))
        s = t0 + 5_200
        engine.append((s * 1000, (s + 100) * 1000, EVALUATE))
        events.append(_kernel("k_engine", s, 50, ["aten::mul", "MulBackward0", EVALUATE]))
        events.append(trace.DeviceEvent("Memcpy HtoD", "gpu_memcpy", t0 * 1000 + 1000,
                                        t0 * 1000 + 1_000_000, ("r3m.step.augment",)))
    return _ctx(events, {MAIN: sorted(main), ENGINE: engine})


@pytest.mark.parametrize("index,phase", list(enumerate(PHASES)))
def test_kernels_under_a_phase_are_summed_a_step(index, phase):
    got = harness.load_module("layer_metrics", f"{phase}_ms.train").read(_train_window())
    want = (index + 1) * 0.1 + (0.05 if phase == "backward" else 0.0)
    assert got == pytest.approx(want)


def test_backward_kernels_on_the_engine_thread_count():
    ctx = _train_window()
    backward = harness.load_module("layer_metrics", "backward_ms.train")
    spans_only = harness.load_module("layer_metrics", "encode_ms.train")
    assert backward.read(ctx) - 0.5 == pytest.approx(0.05)
    assert spans_only.read(ctx) == pytest.approx(0.3)


def test_a_kernel_counts_for_its_innermost_phase():
    """A range of one step around the ops of the next (torch's optimizer annotation, whose
    copy on the device's timeline outlasts the host's range) adds outer phases to a chain:
    the kernel counts for its innermost phase alone."""
    ctx = _train_window()
    stale = ("Optimizer.step#Adam.step", "r3m.step.optimizer", "r3m.step")
    ctx.ops.events.append(_kernel("k_late", 30_000, 1000,
                                  ["aten::mm", "r3m.step.encode", "r3m.step", *stale]))
    read = {p: harness.load_module("layer_metrics", f"{p}_ms.train").read(ctx) for p in PHASES}
    assert read["encode"] == pytest.approx(0.3 + 0.5)
    assert read["optimizer"] == pytest.approx(0.6)


@pytest.mark.parametrize("name", [f"{p}_ms.train" for p in PHASES]
                         + ["check_ms.latency", "dense_epilogue_ms.serve"])
def test_a_window_without_the_spans_reads_none(name):
    reader = harness.load_module("layer_metrics", name)
    assert reader.read(_train_window(with_spans=False)) is None
    no_ops = harness.Context({}, {}, 2, 1.0, {}, {}, None, 0, None)
    assert reader.read(no_ops) is None


@pytest.mark.parametrize("phase", PHASES)
def test_a_window_without_device_events_reads_none(phase):
    """A run on the CPU records the spans but no kernel: no device time is read."""
    ctx = _train_window()
    ctx.ops.events = []
    assert harness.load_module("layer_metrics", f"{phase}_ms.train").read(ctx) is None


def test_dense_epilogue_and_the_check():
    events, main = [], []
    for request in range(3):
        t0 = request * 10_000
        main.append((t0 * 1000, (t0 + 9_000) * 1000, "r3m.encoder"))
        main.append((t0 * 1000 + 10, t0 * 1000 + 10 + 200_000 * (request + 1),
                     "r3m.encoder.check"))
        for j in range(4):
            s = t0 + 1000 + 100 * j
            main.append((s * 1000, (s + 50) * 1000, "r3m.dense.epilogue"))
            events.append(_kernel("add", s, 20, ["aten::add", "r3m.dense.epilogue",
                                                 "r3m.encoder.embed", "r3m.encoder"]))
            events.append(_kernel("gemm", s + 30, 40, ["aten::mm", "r3m.encoder.embed",
                                                       "r3m.encoder"]))
    ctx = _ctx(events, {MAIN: sorted(main)}, units=3)
    dense = harness.load_module("layer_metrics", "dense_epilogue_ms.serve")
    check = harness.load_module("layer_metrics", "check_ms.latency")
    assert dense.read(ctx) == pytest.approx(4 * 0.02)
    assert check.read(ctx) == pytest.approx(0.4)  # the median of 0.2, 0.4 and 0.6 ms
