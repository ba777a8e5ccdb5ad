"""The DINOv2 cell and the ResNet-50 embedding cell: the manifest names their pieces, the
yardstick's arithmetic for DINOv2 matches counts worked out by hand, the new readers read
hand-built traced windows, and both cells run through the harness on the CPU at a small
size, where the comparison passes in f32 and fails in bf16 or with the answers altered."""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import sys
import time

import pytest

from port_bench import dinov2_flops, flops, harness, trace
from port_bench.tests.tiny import SEED, tiny_spec

DINO = "serve_dinov2_g14_b256"
RESNET = "serve_resnet50_b256_fast"
NEW_METRICS = ("dinov2_mfu.serve", "dinov2_attention_roofline.serve", "swiglu_gate_ms.serve",
               "layerscale_ms.serve")
F32_LIMITS = {"embed_gap": 1e-5}


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _metric(manifest, name):
    return next(m for m in manifest["end_to_end"] + manifest["per_layer"] if m["name"] == name)


def test_manifest_lists_the_configuration_cells_and_metrics(manifest):
    config = next(c for c in manifest["configs"] if c["name"] == "dinov2_vitg14_reg")
    assert config["file"] == "port_bench/configs/dinov2_vitg14_reg.json" and not config["reduced"]
    cells = {w["name"]: w for w in manifest["workloads"]}
    assert (cells[DINO]["config"], cells[DINO]["traffic"]) == ("dinov2_vitg14_reg",
                                                               "embed_b256_dinov2")
    assert (cells[RESNET]["config"], cells[RESNET]["traffic"]) == ("r3m_resnet50", "embed_b256")
    assert harness.find_cell(DINO).mix["driver"] == "serve_dinov2"
    for name in (DINO, RESNET):
        assert name in _metric(manifest, "serve_frames_per_s")["workloads"]
    for name in ("step_mfu.serve", "idle_share.serve", "h2d_ms.serve", "cast_ms.serve"):
        assert RESNET in _metric(manifest, name)["workloads"]
    for name in ("idle_share.serve", "h2d_ms.serve", "dense_epilogue_ms.serve", *NEW_METRICS):
        assert DINO in _metric(manifest, name)["workloads"]
    for name in NEW_METRICS:
        m = _metric(manifest, name)
        assert m["workloads"] == [DINO] and m["moves"] == "serve_frames_per_s"


def test_configuration_holds_the_published_widths():
    bb = harness.find_cell(DINO).config["backbone"]
    published = dict(dim=1536, n_layers=40, n_heads=24, head_dim=64, ffn_dim=4096,
                     weights_in_dim=8192, patch_size=14, position_grid=37, n_positions=1370,
                     n_registers=4, layer_norm_eps=1e-6)
    assert {k: bb[k] for k in published} == published
    assert bb["position_grid"] ** 2 + 1 == bb["n_positions"]


def test_forward_macs_from_the_widths():
    cell = harness.find_cell(DINO)
    bb, size = cell.config["backbone"], cell.config["model"]["image_size"]
    assert dinov2_flops.tokens(bb, size) == 261
    d, f = 1536, 4096
    want = 256 * 3 * 14 * 14 * d + 40 * (261 * (4 * d * d + 3 * d * f) + 2 * 261 * 261 * d)
    assert dinov2_flops.forward_macs(bb, size) == want
    assert abs(want / 304.2e9 - 1) < 1e-3
    assert abs(dinov2_flops.serve_request_flops(cell.config, cell.mix) / 155.7e12 - 1) < 1e-3


def test_attention_bound_is_its_bytes():
    cell = harness.find_cell(DINO)
    shape = dinov2_flops.attention_shape(cell.config, 256)
    assert shape == (256, 261, 24, 64)
    least, by = flops.bound_s(*flops.attention_fwd(*shape, "bfloat16"), "bfloat16")
    assert by == "bytes" and abs(least * 1e3 - 0.24509) < 1e-5
    request = dinov2_flops.attention_request_bound_s(cell.config, cell.mix, "bfloat16")
    assert abs(request * 1e3 - 9.8034) < 1e-3


def _kernel(name, start_us, us, ops):
    return trace.DeviceEvent(name, "kernel", start_us * 1000, (start_us + us) * 1000,
                             tuple(ops))


def _ctx(events, host_ops, units=2):
    cell = harness.find_cell(DINO)
    win = trace.Window(1.0, events, 0.0, [], {1: sorted(host_ops)})
    return harness.Context(cell.config, cell.mix, units, 10.0, {}, {}, None, units, win)


def _request_window(with_spans=True, units=2):
    """Per request: 40 layers, each with a tiled attention kernel of 500 us, a gate kernel
    of 30 us and two layer-scale kernels of 10 us, each under its span."""
    events, host = [], []
    for r in range(units):
        for layer in range(40):
            t0 = (r * 40 + layer) * 1000
            for name, at, us, span in (("attention_fwd_bf16_tiled_kernel", 0, 500, None),
                                       ("silu_mul", 600, 30, "r3m.swiglu.gate"),
                                       ("addcmul", 700, 10, "r3m.layerscale"),
                                       ("addcmul", 800, 10, "r3m.layerscale")):
                ops = ["aten::op"]
                if span:
                    label = span if with_spans else "r3m.other"
                    host.append(((t0 + at) * 1000, (t0 + at + us + 5) * 1000, label))
                    ops.append(label)
                events.append(_kernel(name, t0 + at, us, ops + ["r3m.encoder.embed"]))
    return _ctx(events, host, units)


def test_readers_of_a_traced_window():
    ctx = _request_window()
    read = {n: harness.load_module("layer_metrics", n).read(ctx) for n in NEW_METRICS}
    least = dinov2_flops.attention_request_bound_s(ctx.config, ctx.mix, "bfloat16")
    assert read["dinov2_attention_roofline.serve"] == pytest.approx(100 * least / 0.020)
    assert read["swiglu_gate_ms.serve"] == pytest.approx(40 * 0.030)
    assert read["layerscale_ms.serve"] == pytest.approx(40 * 0.020)
    work = dinov2_flops.serve_request_flops(ctx.config, ctx.mix)
    assert read["dinov2_mfu.serve"] == pytest.approx(100 * work * 2 / 10.0 / 989e12)


@pytest.mark.parametrize("name", ["swiglu_gate_ms.serve", "layerscale_ms.serve"])
def test_a_window_without_the_spans_reads_none(name):
    reader = harness.load_module("layer_metrics", name)
    assert reader.read(_request_window(with_spans=False)) is None
    assert reader.read(dataclasses.replace(_request_window(), ops=None)) is None


def test_roofline_without_attention_kernels_reads_none():
    reader = harness.load_module("layer_metrics", "dinov2_attention_roofline.serve")
    ctx = _request_window()
    ctx.ops.events = [e for e in ctx.ops.events if "attention" not in e.name]
    assert reader.read(ctx) is None


def tiny_dinov2_spec() -> harness.CellSpec:
    """The DINOv2 cell at 42 px (a 3 x 3 grid from a 4 x 4 table), dim 128 in two heads
    of 64, two layers, two registers, 4 frames a request."""
    spec = harness.find_cell(DINO)
    cfg = copy.deepcopy(spec.config)
    cfg["model"]["image_size"] = 42
    cfg["backbone"].update(dim=128, n_layers=2, n_heads=2, ffn_dim=344, n_registers=2,
                           position_grid=4)
    spec.config = cfg
    spec.mix = dict(spec.mix, frame_size=42, frames=4, pool=2, sampled=2)
    return spec


def _run(spec, precision, fault=None, traced=False):
    spec = dataclasses.replace(spec, limits=F32_LIMITS, mix=dict(spec.mix, precision=precision))
    result, checks = harness.run_cell(spec, SEED, 0.2, traced, "cpu", time.perf_counter(),
                                      fault=fault)
    return result, checks["embed_gap"]["value"]


@pytest.mark.parametrize("spec", [tiny_dinov2_spec, lambda: tiny_spec(RESNET)],
                         ids=["dinov2", "resnet50_b256"])
def test_the_new_cells_compare_on_the_cpu(spec):
    ok, gap = _run(spec(), "parity")
    assert ok["correct"] and ok["attempted"] > 0 and ok["failed"] == 0, gap
    lower, gap = _run(spec(), "fast")
    assert not lower["correct"] and gap > 10 * F32_LIMITS["embed_gap"]
    altered, _ = _run(spec(), "parity", fault="altered")
    assert not altered["correct"]


def test_the_dinov2_cell_traced_on_the_cpu():
    result, _ = _run(tiny_dinov2_spec(), "parity", traced=True)
    assert result["correct"] and "dinov2_mfu.serve" in result["metrics"]


def test_a_program_without_the_backbone_fails_at_once(monkeypatch):
    monkeypatch.setitem(sys.modules, "r3m_tpu_torch.models.dinov2", None)
    spec = tiny_dinov2_spec()
    driver = harness.load_module("drivers", spec.mix["driver"])
    t0 = time.perf_counter()
    with pytest.raises(ImportError):
        driver.Cell(spec.config, spec.mix, SEED, "cpu")
    assert time.perf_counter() - t0 < 5.0
