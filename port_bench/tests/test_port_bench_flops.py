"""The yardstick's arithmetic against published counts and counts worked out by hand."""

from __future__ import annotations

from port_bench import flops, harness


def _config(name):
    return harness.find_cell(name).config


def test_resnet50_at_224_is_4_1_gmac():
    macs = flops.resnet_forward_macs(_config("train_resnet50")["backbone"], 224)
    assert abs(macs / 4.1e9 - 1) <= 0.02, macs


def test_vit_b32_at_224_from_its_widths():
    d, t, mlp, patches = 768, 50, 3072, 49
    per_layer = t * (3 * d * d + d * d + 2 * d * mlp) + 2 * t * t * d
    want = patches * (3 * 32 * 32) * d + 12 * per_layer + d * d
    assert flops.vit_forward_macs(_config("train_vit_b32")["backbone"]) == want
    assert abs(2 * want / 8.8e9 - 1) < 0.01


def test_train_step_counts_three_passes_and_the_frozen_language_model_once():
    cell = harness.find_cell("train_resnet50")
    parts = flops.train_step_flops(cell.config, cell.mix)
    assert parts["encoder"] == 3 * 320 * 2 * flops.resnet_forward_macs(
        cell.config["backbone"], 224)
    bert = 6 * (32 * (4 * 768 * 768 + 2 * 768 * 3072) + 2 * 32 * 32 * 768)
    assert parts["language"] == 2 * 64 * bert
    assert abs(sum(parts.values()) / 8.07e12 - 1) < 0.01


def test_kernel_bounds_match_the_bytes_each_op_must_move():
    # the stem pool of a step (320 frames): 514 MB read, 128 MB + 64 MB argmax written
    fwd = flops.bound_s(*flops.maxpool_fwd(320, 112, 112, 64, "bfloat16", True), "bfloat16")
    bwd = flops.bound_s(*flops.maxpool_bwd(320, 112, 112, 64, "bfloat16"), "bfloat16")
    assert fwd[1] == bwd[1] == "bytes"
    assert abs(fwd[0] * 1e3 - 0.2109) < 1e-4 and abs(bwd[0] * 1e3 - 0.2109) < 1e-4
    # attention at 50 tokens: Q, K, V, O (forward) and Q, K, V, dO, dQ, dK, dV (backward)
    fwd = flops.bound_s(*flops.attention_fwd(320, 50, 12, 64, "bfloat16"), "bfloat16")
    bwd = flops.bound_s(*flops.attention_bwd(320, 50, 12, 64, "bfloat16"), "bfloat16")
    assert abs(fwd[0] * 1e3 - 0.0293) < 1e-4 and abs(bwd[0] * 1e3 - 0.0514) < 1e-4
