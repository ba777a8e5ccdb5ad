"""The harness: it finds a cell's pieces by name, runs the cell's driver, reads the
end-to-end metrics from the driver and the per-layer ones from their readers, decides
`correct` from the driver's comparison with the plain reference, and builds the result.

A cell is found by name through ``BENCHMARK.json``: its configuration in
``port_bench/configs/<config>.json``, its traffic mix in ``port_bench/traffic/<mix>.json``
(which names its driver, ``port_bench/drivers/<driver>.py``), its limits in
``port_bench/workloads/<cell>.json``, and each per-layer metric's reader in
``port_bench/layer_metrics/<metric>.py``. A driver module defines ``Cell(cfg, mix,
seed, device, fault=None)`` with ``window(seconds, probe, spans)``, ``release()`` and
``check()``; a reader defines ``read(ctx) -> float | None``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import torch

from port_bench import trace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "r3m_tpu")
OPS_WINDOW_S = 5.0  # the traced run's window with host ops, after its device-only window
LAUNCH_COUNTERS = {
    "K1": ("r3m_tpu_torch.ops.pool", "maxpool_3x3s2_fwd"),
    "K2": ("r3m_tpu_torch.ops.pool", "maxpool_3x3s2_bwd"),
    "K3": ("r3m_tpu_torch.ops.attention", "fused_attention_fwd"),
    "K4": ("r3m_tpu_torch.ops.attention", "fused_attention_bwd"),
}


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``port_bench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"port_bench_{kind}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class CellSpec:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: str = ROOT) -> CellSpec:
    manifest = load_json(root, "BENCHMARK.json")
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    return CellSpec(
        name=name,
        chips=entry["chips"],
        config=load_json(root, config["file"]),
        mix=load_json(HERE, "traffic", f"{entry['traffic']}.json"),
        limits=load_json(HERE, "workloads", f"{name}.json")["limits"],
        end_to_end=[m for m in manifest["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in manifest["per_layer"] if _applies(m, name)],
    )


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one the benchmark may not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def launches() -> Dict[str, int]:
    out = {}
    for key, (module, fn) in LAUNCH_COUNTERS.items():
        mod = sys.modules.get(module)
        out[key] = getattr(getattr(mod, fn), "launches", 0) if mod is not None else 0
    return out


@dataclasses.dataclass
class Context:
    """What a per-layer reader reads. A traced run measures three windows one after the
    other. The first is not traced: its `units` (steps or requests), its `window_s` and
    the harness's `spans` (lists of seconds by name) are what an untraced run measures.
    The second records the card's activity alone (`window`), which costs the host a few
    microseconds a launch: the device's busy and idle time come from it. The third, shorter
    one also records every host op (`ops`, its `ops_units`), so its device events carry the
    ops that launched them: the device time of an op or a kind of kernel comes from it.
    `launches` are the kernels' launch counters' increments over the first window."""

    config: dict
    mix: dict
    units: int
    window_s: float
    spans: Dict[str, List[float]]
    launches: Dict[str, int]
    window: Optional[trace.Window] = None
    ops_units: int = 0
    ops: Optional[trace.Window] = None


def checks_ok(checks: Dict[str, dict]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())


def run_cell(spec: CellSpec, seed: int, seconds: float, traced: bool, device: str,
             t_start: float, fault: Optional[str] = None) -> Tuple[dict, Dict[str, dict]]:
    """One run of a cell: set-up, the measured window, the comparison. Returns the result
    (without `device`'s card fields) and the numbers compared, each with its limit."""
    driver = load_module("drivers", spec.mix["driver"])
    t_cell = time.perf_counter()
    cell = driver.Cell(spec.config, spec.mix, seed, device, fault=fault)
    setup_s = time.perf_counter() - t_start
    phases = {"start": t_cell - t_start, **cell.phases}
    spans: Dict[str, List[float]] = {}
    before = launches()
    out = cell.window(seconds, trace.Probe(None), spans)
    counts = {k: v - before[k] for k, v in launches().items()}
    memory_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    attempted, failed = out["attempted"], out["failed"]
    metrics = {}
    device_info = {"memory_peak_bytes": memory_peak}
    extra = {}
    if traced:
        runs = []
        for mode, length in (("device", seconds), ("ops", min(seconds, OPS_WINDOW_S))):
            probe = trace.Probe(mode)
            runs.append(cell.window(length, probe, {}))
            runs[-1]["trace"] = trace.reduce(probe.prof, runs[-1]["window_s"])
            probe.prof = None
        attempted += sum(r["attempted"] for r in runs)
        failed += sum(r["failed"] for r in runs)
        (dev, ops) = runs
        ctx = Context(spec.config, spec.mix, out["attempted"], out["window_s"], spans, counts,
                      dev["trace"], ops["attempted"], ops["trace"])
        for m in spec.per_layer:
            value = load_module("layer_metrics", m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=dev["trace"].busy_s, window_s=dev["trace"].window_s)
        extra["breakdown"] = trace.breakdown(dev["trace"], ops["trace"])
        ctx = runs = dev = ops = None
    else:
        e2e = dict(out["end_to_end"], setup_s=setup_s)
        for m in spec.end_to_end:
            if e2e.get(m["name"]) is None:
                if device == "cuda":
                    raise RuntimeError(f"the {spec.mix['driver']} driver gives no {m['name']}")
                continue  # a reading of the card alone, such as its memory
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    result = {"correct": False, "attempted": attempted, "failed": failed, **extra}
    result["metrics"] = metrics
    result["device"] = device_info
    result["launches"] = counts
    result["setup_phases_s"] = phases
    if "request_ms_p50_p90_p95_p99" in out:
        result["request_ms_p50_p90_p95_p99"] = out["request_ms_p50_p90_p95_p99"]
    cell.release()
    numbers = cell.check()
    checks = {k: {"value": numbers.get(k, math.nan), "limit": limit}
              for k, limit in spec.limits.items()}
    result["correct"] = bool(checks) and checks_ok(checks)
    return result, checks
