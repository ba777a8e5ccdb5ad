"""``BENCHMARK.json`` names only pieces that exist, each found by name, in the form the
benchmark's contract gives them."""

from __future__ import annotations

import json
import os
import re

import pytest

from port_bench import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_command_and_paths(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert manifest["command"] == ["python3", "port_bench/run.py"]
    assert manifest["paths"] == ["port_bench"]
    assert 1 <= manifest["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_lines(manifest):
    entries = (manifest["configs"] + manifest["workloads"] + manifest["end_to_end"]
               + manifest["per_layer"])
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in manifest[group]]
        assert len(names) == len(set(names)), group
    lines = [e[k] for e in entries for k in ("why", "layer") if k in e]
    lines += [c["source"] for c in manifest["configs"]] + manifest["command"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for line in lines:
        assert 1 <= len(line) <= 200 and "\n" not in line and "\t" not in line, line
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


def test_every_piece_resolves_by_name(manifest):
    for c in manifest["configs"]:
        assert c["file"].startswith("port_bench/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert c["reduced"] == []
    for w in manifest["workloads"]:
        spec = harness.find_cell(w["name"])
        assert w["chips"] == 1
        assert os.path.exists(os.path.join(harness.HERE, "drivers", f"{spec.mix['driver']}.py"))
        assert hasattr(harness.load_module("drivers", spec.mix["driver"]), "Cell")
        assert spec.limits
    for m in manifest["per_layer"]:
        assert callable(harness.load_module("layer_metrics", m["name"]).read)


def test_every_cell_reports_what_its_metrics_move(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace") for m in e2e.values())
    for w in manifest["workloads"]:
        spec = harness.find_cell(w["name"])
        reported = {m["name"] for m in spec.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2, w["name"]
        assert spec.per_layer, w["name"]
        for m in spec.per_layer:
            assert m["moves"] in reported, (w["name"], m["name"])
    for m in manifest["per_layer"]:
        assert set(m["workloads"]) <= {w["name"] for w in manifest["workloads"]}
        if "_roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
