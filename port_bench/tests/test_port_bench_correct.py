"""The comparison that decides `correct`, run through the harness on the CPU at a small
size: the plain reference agrees with ``r3m_tpu_torch`` where both compute in f32; the
same comparison fails where the system's side runs in a lower precision, and where the
timed path is broken underneath (each fault a cell can have). The controls at the cells'
own precision run on the card (`cuda` marker)."""

from __future__ import annotations

import dataclasses
import time

import pytest
import torch

from port_bench import calibrate, harness
from port_bench.tests.tiny import CELLS, SEED, tiny_spec

F32_LIMITS = {"train": {"loss_gap": 1e-3, "grad_gap": 2e-3, "var_gap1": 1e-4},
              "serve": {"embed_gap": 1e-5}}


def _run(spec, fault=None):
    result, checks = harness.run_cell(spec, SEED, 0.2, False, "cpu", time.perf_counter(),
                                      fault=fault)
    return result, {k: c["value"] for k, c in checks.items()}


def _f32(name: str, lower: bool):
    """The tiny cell in f32 (train: compute dtype; serve: parity), held to limits that
    only f32 meets; `lower` runs the system's side in bf16 (train) or fast (serve)."""
    spec = tiny_spec(name)
    if spec.mix["driver"] == "train_step":
        spec.config["model"]["compute_dtype"] = "bfloat16" if lower else "float32"
        limits = dict(F32_LIMITS["train"])
        if spec.config["backbone"]["kind"] == "vit":
            del limits["var_gap1"]  # no BatchNorm
    else:
        spec.mix = dict(spec.mix, precision="fast" if lower else "parity")
        limits = F32_LIMITS["serve"]
    return dataclasses.replace(spec, limits=limits)


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_in_f32(name):
    result, numbers = _run(_f32(name, lower=False))
    assert result["correct"], numbers
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_lower_precision_fails(name):
    result, numbers = _run(_f32(name, lower=True))
    assert not result["correct"], numbers


FAULTS = [(c, "unchanged") for c in CELLS[:2]] + [(c, "half") for c in CELLS[:2]] + [
    (c, "altered") for c in CELLS[2:]]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(name, fault):
    """With each cell's own limits: a step that returns its state unchanged, half of the
    batch left out (the mean over the rest), an answer altered where it is produced."""
    result, numbers = _run(tiny_spec(name), fault=fault)
    assert not result["correct"], (fault, numbers)


@pytest.mark.parametrize("name", CELLS[:2])
def test_fp8_control_reads_above_the_system(name):
    """The control of a bf16 cell, the reference with fp8 products, reads at least three
    times the system's reading in one of the cell's numbers."""
    spec = tiny_spec(name)
    got = calibrate.readings(spec, SEED, 0.2, True, "cpu")
    assert any(got["control"][k] >= 3 * got["sound"][k] for k in spec.limits), got


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_the_card(name):
    """On the card, at the cells' widths with a smaller batch: the system passes the
    cell's limits and its control (TF32 under f32, fp8 under bf16) fails one of them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spec = harness.find_cell(name)
    if spec.mix["driver"] == "train_step":
        spec.mix = dict(spec.mix, clips=16)
    else:
        spec.mix = dict(spec.mix, pool=min(spec.mix["pool"], 4))
    got = calibrate.readings(spec, SEED, 1.0, True, "cuda")
    assert all(got["sound"][k] <= v for k, v in spec.limits.items()), got
    assert any(got["control"][k] > v for k, v in spec.limits.items()), got
