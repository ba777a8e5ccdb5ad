"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py            # from the root of a checkout; needs one CUDA card
    python3 chip_smoke.py --parent-attention OLD.cu   # also time another attention.cu

With ``--parent-attention`` (a copy of an earlier ``r3m_tpu_torch/csrc/attention.cu``,
e.g. from ``git show <commit>:r3m_tpu_torch/csrc/attention.cu``) that source is built
beside the checkout's, and K3 in bf16 and f32 at ViT-B/32's 384 px serving and training
shapes, K4 at the training shape, the 384 px request in fast and parity precision and the
384 px training step in bf16 and f32 run through both in turns: both kernels' times, how
far apart their outputs are (and whether they are equal bit for bit), both requests'
frames/s and both steps' train frames/s.

Phases, in order; any failure ends the run with a non-zero exit and no result line:

1. print the card's name and power limit (nvidia-smi);
2. build every kernel of ``r3m_tpu_torch/csrc`` from the checkout's sources, and print
   what ``-Xptxas -v`` says of the maxpool, the bf16 and the f32 attention kernels
   (registers, shared memory, spills); the maxpool and f32 attention kernels, the bf16
   backward's one-block form past 128 tokens, the dense GEMMs and the layer_norm kernels
   must neither spill nor use a stack frame;
3. each kernel against its plain PyTorch version on the card, at the shapes the serving
   and training paths give it, f32 and bf16, with the times of the kernel, the plain
   version and one library call, and the bound:
   K1 (stem max-pool, with and without its int8 argmax, on an input full of ties) and K2
   (its backward) exact; K3 (fused attention) and K4 (its recompute-P backward) to a
   stated atol and to a relative L2 error that tells whether they round where their
   plain versions do, K4 also against autograd of K3's plain forward, at ViT-B/32's
   heads at 224 px (T = 50, one block a head) and at 384 px (T = 145, the head form: one
   block a head walking its keys in bf16, its query rows in f32), K3 alone at DINOv2-g/14's
   request (``dinov2_serve``: 256 frames of T = 261 in 24 heads of 64, key tiles), and at
   T = 577 (768 px, key tiles, correctness only), with the form K3 and K4 took at each
   (`attention_fwd_path`, `attention_bwd_path`) and the head forms' blocks an SM
   (`attention_head_blocks_per_sm`); the fused `dense` product (`check_dense`) against
   the unfused order at ViT-B/32's and DINOv2-g/14's widths (dx at ViT's training rows),
   within one bf16 step, timed beside the f32-result product, with cuBLASLt's answer on an
   f32 bias with a bf16 output; `layer_norm`'s kernels (`check_layer_norm`) against the
   composition at DINOv2-g/14's request, ViT-B/32's request and its training step (the
   backward there), timed beside ATen's ``F.layer_norm`` with bf16 parameters, with what
   ATen does with f32 parameters and a bf16 x; under grad a CUDA call carries
   a grad_fn and its backward is the kernel; each row also gives the kernel's time over
   the library call's (`library_ratio`), the bound over the kernel's time
   (`bound_share`) and the bytes the function must move over the kernel's time
   (`gbytes_per_s`);
4. one fast request of 8 frames to DINOv2-g/14 with registers (``serve_dinov2_g14``,
   seeded random weights drawn on the card): `layer_norm`'s forward 81 launches (two a
   layer and the final one on the class token's rows), the fused `dense` 240, K3 40.
   Then ResNet-50 serving through ``load_r3m_from_files`` (seeded random weights written as a
   reference ``model.pt``), parity and fast: a few requests of 256 frames at 224 px and
   one of 240x320 frames; shapes, finiteness, fast-vs-parity cosine, agreement with the
   CPU path on a small input, and K1's launches over the served requests. Then
   ``python -m r3m_tpu_torch.example`` through its `main` (``example_resnet50``), offline:
   an empty ``$R3M_HOME`` and a fetch that fails at once, so it serves its random-init
   ResNet-50 and prints ``[1, 2048]``; and one fast request of 256 frames to that encoder
   traced with `utils/profiling.trace`, whose op profile (`op_profile_raw`) counts K1's
   kernel as many times as K1's launch counter counted in the request (its top rows and
   K1's share of the device time printed). Then that
   ``model.pt`` through the embed CLI over 130 PNG files of 240x320 (batches of 64 and a
   tail of 2), parity and fast: frames/s of the whole CLI, the paths in order, K1 once a
   batch, parity against `R3MEncoder` on the same decoded arrays (cosine > 0.9999);
5. ViT-B/32 serving, the same, with K3's launches, the fused `dense` product's (73 a
   fast request, none in parity) and `layer_norm`'s (25 a request in either precision),
   and its fast-vs-parity cosine again
   with the fast forward's attention through K3's plain version on the card (K3's share
   of the bf16 path's distance from parity); then ViT-B/32 at 384 px (T = 145), one
   request of 64 frames; then mesh serving: ``load_r3m_from_files(...,
   mesh=make_mesh(1))`` of ResNet-50 and ViT-B/32, parity and fast, a request of 256
   frames, bit-equal to the same encoder without a mesh (K1, K3 counted), and the embed
   CLI with ``--n-devices 1``, bit-equal to its output in 4;
6. the ResNet-50 pretraining step, bf16, 64 clips of 5 frames at 224 px on the device,
   rctraj, language + TCN + L1/L2 losses, 3 negatives, Adam 1e-4, a frozen DistilBERT of
   base geometry: warm-up steps, then timed steps on one repeated batch, each drawing
   its crops and negatives from the state's generator. The loss is finite, the step
   counts, K1 and K2 launch once a step, the BatchNorm statistics move, every trainable
   parameter has a finite, non-zero gradient; train frames/s and peak device memory.
   Then a few more steps with the crops and negatives held fixed: the loss falls;
7. snapshot and resume: that state saved with ``save_train_snapshot`` and loaded into a
   fresh state of another seed; the next step of both, crops and negatives fixed, gives
   the same loss, through K1 and K2; save and load seconds, the snapshot's bytes;
8. the ViT-B/32 pretraining step, the same as 6, with 12 launches of K3 and of K4 a step,
   73 of the fused `dense` product and of its dx and 25 of `layer_norm`'s forward and of
   its backward (in f32 too); then at 384 px, 16 clips, 3 timed steps, in bf16 (``train_vit_b32_384``) and in f32
   (``train_vit_b32_384_f32``: K3 and K4 in the f32 head form);
9. the ViT-B/32 pretraining step in f32, the same but for 5 timed steps, with no TF32
   flag set by this script (the step runs in true f32 itself, as the 384 px f32 step of
   8 does): the f32 K3 and K4 at full width, 12 launches of each a step; then that state
   saved and served through ``load_r3m_from_snapshot`` in fast precision, against the
   live model in parity (K3 12 times, the fused `dense` 73, `layer_norm` 25);
10. reward scoring (`R3MRewardModel`): the ResNet-50 state of 6 saved as an ``.npz`` with a
   base-geometry DistilBERT (``distilbert.npz`` with ``bert_config`` metadata, the training
   phases' frozen encoder) and a vocab, scored in parity and fast precision: 32 (start,
   current) pairs of 224 px frames from host memory against 32 sentences padded to 32
   tokens, 2 warm-up and 10 timed queries (queries/s, pairs/s, ms a query), then a reward
   curve over 50 frames (ms); K1 once a query; parity within a stated share of the
   rewards' spread of the same snapshot scored on the CPU, fast within a stated atol of
   parity.
   Then the f32 ViT-B/32 state of 9 as a reference ``snapshot.pt`` with the DistilBERT
   embedded (``module.lang_enc.model.*``), scored through ``from_torch_snapshot`` the same
   way in parity, K3 12 times a query, against the CPU; and that ``snapshot.pt`` through
   the convert CLI, ``to-native`` then ``to-torch``: every tensor comes back exactly;
11. ``remat="conv_saved"`` (``train_resnet50_conv_saved``): the bf16 ResNet-50 step of 6
   with the BatchNorm normalise and ReLUs recomputed in the backward, timed in turns with
   the "none" step (none, conv_saved, conv_saved, none): both train frames/s and peak
   device memory, K1 and K2 once a step; then one step of each from one state with the
   draws held fixed, in bf16 and in f32: the losses, the gradients (the bf16 conv_saved
   gradient as close to the f32 step's as the bf16 "none" one is) and the running
   statistics (moved once) within the stated bounds (`REMAT_*`);
12. the Ego4D training path (``ego4d_train_resnet50``): an Ego4D-layout dataset written
   by `write_synthetic_dataset` (48 videos of 12-40 JPEG frames at 224 px, captions of the
   reward sentences) and the training phases' DistilBERT; `Workspace` on the repo's
   ``cfgs/config_rep.yaml`` with the README's settings (ResNet-50, langweight 1, rctraj,
   bf16, 64 clips a step, one decode thread a core), 25 steps with an eval and a snapshot
   every 10 (phase A), then a second `Workspace` on the same folder that auto-resumes
   from A's last snapshot with the data stream fast-forwarded and trains 10 more (phase
   B). It prints the JPEG decoder that ran (native, or PIL and why), the host's cores, the
   delivered train frames/s, the input wait's share of the step time and the host's
   share queueing the steps over the steps
   after each phase's first two, beside the device-only frames/s of phase 6, the snapshot
   and resume seconds, and K1/K2's launches (K2 once a step, K1 once a step and once an
   eval batch); the loss is finite and both CSV files hold their rows. Then the native
   decoder against PIL on 300 of the dataset's frames, where the native library built
   (mean abs difference at most 1 grey level);
13. the downstream probe (``probe_delta_resnet50``): ``python -m r3m_tpu_torch.probe_delta``
   through its `main` on the card: the reach world at 224 px (32 videos of 20 frames),
   ResNet-50 at the README's settings (16 clips, rctraj, langweight 1) for 30 steps through
   `Workspace`, then three random inits, the step-0 snapshot and the trained snapshot
   scored on 12 held-out videos of 10 frames (reward order, BC probe, linear probes,
   caption contrast through `R3MRewardModel`): three rows with every metric finite, K1
   and K2 launched; the seconds of each part and the delivered train frames/s. Then the
   BC probe on the trained snapshot's embeddings on the card against the CPU from the
   same weights and minibatches, in true f32 on both (`PROBE_BC_RTOL`);
14. the data-parallel steps, in spawned children that own their process group:
   ``dp_train_resnet50``, one rank over NCCL, the bf16 step of 6 through the
   data-parallel code (BatchNorm statistics all-reduced, embeddings gathered, gradients
   averaged) timed in turns with the plain step (plain, dp, dp, plain; 2 warm-up and 10
   timed steps each): both frames/s, their ratio, peak memory, the collectives a step by
   kind (calls, bytes), K1/K2 once a step; then 3 steps from one state with fixed draws
   through both, the losses within `DP_BF16_LOSS_RTOL`. ``dp_train_gloo2``, two gloo
   ranks on the one card, each with its half of one global batch (`local_rows`), f32
   ResNet-18 at 64 px (64 clips; K1, K2) and ViT-B/32 at 224 px (16 clips; K3, K4): the
   ranks' losses bit-equal, and rank 0 held to the plain step on the whole batch (see
   `dp_gloo2_child`). ``ego4d_train_dp``: `Workspace` with ``distributed_init=true`` joins
   a world of one over NCCL by itself and trains 10 steps of 16 clips on the dataset of
   12, one eval, one snapshot, the ``[distributed]`` line printed (it runs first in the
   child of ``dp_train_resnet50``, which then uses its process group);
   ``dp_train_resnet50_conv_saved``, in the same child: one data-parallel step with remat
   "none" and one with "conv_saved", the same collectives (calls and bytes by kind);
15. a small f32 step (ResNet-18 at 32 px, ViT at 64 px) on the card and on the CPU from
   the same state, batch, permutations and crops: loss and gradients agree;
16. one JSON line with every kernel's numbers, then the result line.

Each path's launch counts are set to 0 just before it runs and read just after (in the
children, by the children); the kernel checks of phase 3 are not counted. Uses no JAX: the port is checked against its
own plain versions and its CPU path.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import csv
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

SEED = 0
SERVE_BATCH = 256
SERVE_REQUESTS = 3
TRAIN_CLIPS = 64
FRAMES = 5
TRAIN_BATCH = TRAIN_CLIPS * FRAMES
LANG_LEN = 32
WARMUP_STEPS = 2
TIMED_STEPS = 10
TIMED_STEPS_F32 = 5
LEARN_STEPS = 5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # f32 without tensor cores
# K3/K4 against their plain versions, which round where the kernels do and sum in
# another order: f32 rounding, or a few bf16 steps of values of order 1.
ATTENTION_ATOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# K3 and K4 round P (and K4 dU) to bf16 where their plain versions do, so only an element
# in a few thousand lands one rounding step apart: each output agrees to relative L2 error
# 5e-4 (without K4's two roundings it would be ~3e-3 away, which the max abs error alone
# cannot tell from one rounding step of a value near 2).
ATTENTION_REL_L2 = {torch.float32: 1e-5, torch.bfloat16: 5e-4}
# K4 against autograd of K3's plain forward, which keeps P and dU in f32: in bf16 the
# kernel's two roundings add a few more steps.
AUTOGRAD_ATOL = {torch.float32: 1e-5, torch.bfloat16: 6e-2}
DT_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}
MAIN_ROW = "train_bf16"  # this slice's main path: the bf16 pretraining step
# The kernels as their mangled names spell them: K1 and K2; K3 and K4's tensor-core
# templates (bf16) and CUDA-core kernels (f32).
POOL_KERNELS = ("maxpool3x3s2_kernel", "maxpool3x3s2_bwd_kernel")
BF16_ATTENTION_KERNELS = ("attention_fwd_bf16_kernel", "attention_bwd_bf16_kernel",
                          "attention_fwd_bf16_tiled_kernel", "attention_bwd_dq_bf16_kernel",
                          "attention_bwd_dkdv_bf16_kernel", "attention_fwd_bf16_head_kernel",
                          "attention_bwd_bf16_head_kernel")
# Of those, the kernels held to no spill and no stack frame: K3's and K4's one-block forms
# past 128 tokens keep one key chunk's scores a warp (the key-tiled kernels at D > 64 spill).
BF16_NO_SPILL_KERNELS = ("attention_fwd_bf16_head_kernel", "attention_bwd_bf16_head_kernel")
# All held to no spill and no stack frame, the head form's past 124 tokens among them.
F32_ATTENTION_KERNELS = ("attention_fwd_f32_kernel", "attention_bwd_f32_kernel",
                         "attention_fwd_f32_tiled_kernel", "attention_bwd_dq_f32_kernel",
                         "attention_bwd_dkdv_f32_kernel", "attention_fwd_f32_head_kernel",
                         "attention_bwd_f32_head_kernel")
# ViT-B/32 at 384 px: 12 x 12 patches and the class token, more than one block holds whole.
T_384 = 145
# DINOv2-g/14 with registers at 224 px: 16 x 16 patches, the class token and 4 registers,
# in 24 heads of 64 (the serve_dinov2_g14_b256 request), which K3 takes in key tiles.
T_DINOV2 = 261
SERVE_384_BATCH = 64
TRAIN_384_CLIPS = 16
TIMED_STEPS_384 = 3
TIMED_STEPS_PARENT = 20  # each run of the 384 px step against a parent's attention.cu
SERVE_REQUESTS_PARENT = 10  # each run of the 384 px fast request against the parent's
# Reward queries: 32 (start, current) pairs of 224 px frames against 32 sentences padded to
# 32 tokens; a reward curve over a 50-frame trajectory; the embed CLI over 130 images.
REWARD_PAIRS = 32
REWARD_WARMUP = 2
REWARD_QUERIES = 10
CURVE_FRAMES = 50
EMBED_IMAGES = 130
EMBED_BATCH = 64
# Parity rewards on the card against the same model on the CPU, as a share of the CPU
# rewards' spread (max - min over the 32 pairs): they differ only in the order of f32 sums
# in the image encode. Fast against parity (the bf16 image encode), the bound the JAX
# package's own fast-reward test holds (tests/test_reward_model.py).
REWARD_CPU_SHARE = 1e-2
REWARD_FAST_ATOL = 5e-2
VERBS = ("pick up", "open", "close", "put down", "wipe", "turn", "lift", "pour water into")
OBJECTS = ("the cup", "the drawer", "the door", "a bowl on the table", "the counter with a cloth",
           "the knob slowly")
# The Ego4D path: the data mode of the JAX package's bench.py (48 videos of 12-40 frames
# at 224 px); phase A's steps and phase B's, an eval and a snapshot every 10 steps; the
# steps at the start of each phase that the delivered rate leaves out; the frames the
# decoders are held against each other on, and the mean abs difference they may have.
EGO4D_VIDEOS = 48
EGO4D_STEPS_A = 25
EGO4D_STEPS_B = 10
EGO4D_EVAL_FREQ = 10
EGO4D_WARMUP = 2
DECODE_CHECK_FRAMES = 300
DECODE_MEAN_ATOL = 1.0
# The data-parallel phases run in spawned children (the process group lives and dies with
# them), each given this many seconds. dp_train_resnet50 holds its losses over
# DP_SAME_STEPS steps with fixed draws to DP_BF16_LOSS_RTOL of the plain step's: the two
# BatchNorms round the bf16 step's statistics differently (cuDNN's against sums of x and
# x^2 in f32), which moves some bf16 activations by one rounding step. At lr DP_SAME_LR,
# as the CPU tests run: at 1e-4 Adam moves every element by ~lr whatever its gradient's
# size, so an element whose gradient is rounding noise moves either way, and the two
# runs part after a step (3e-2 apart by the third on the CPU at 4 clips).
CHILD_TIMEOUT_S = 400
DP_SAME_STEPS = 3
DP_SAME_LR = 1e-6
DP_BF16_LOSS_RTOL = 2e-2
EGO4D_DP_STEPS = 10
EGO4D_DP_CLIPS = 16
# remat="conv_saved" against "none" on the bf16 ResNet-50 step, from one state with fixed
# draws. The two normalise with different BatchNorm forms (cuDNN's against the JAX form,
# sums of y and y^2 in f32), which moves bf16 activations by a rounding step here and
# there: the loss to DP_BF16_LOSS_RTOL, as the data-parallel step's synced BatchNorm. The
# bf16 gradients of a random-init ResNet-50 are far from the f32 step's whatever the form
# (both ~1.35 in relative L2 on the CPU at 96 px), so the bf16 conv_saved gradient is held
# to be as close to the f32 gradient as the bf16 "none" gradient is (within
# REMAT_BF16_GRAD_RATIO), with a global norm within REMAT_BF16_NORM_RTOL of it; the f32
# conv_saved gradient to REMAT_F32_GRAD_REL_L2 of the f32 "none" one (0.020 on the CPU at
# 96 px: E[y^2] - E[y]^2 against a two-pass variance). The running statistics to
# REMAT_STATS_SHARE of the distance one update moves them: a second update would be 0.9.
REMAT_BF16_GRAD_RATIO = 1.25
REMAT_BF16_NORM_RTOL = 0.25
REMAT_F32_GRAD_REL_L2 = 5e-2
REMAT_STATS_SHARE = 0.1
# The downstream probe on the card: the reach world at 224 px, PROBE_VIDEOS videos of
# PROBE_FRAMES frames, ResNet-50 at the README's settings (16 clips, rctraj, langweight 1)
# for PROBE_STEPS steps, a held-out set of PROBE_SET_VIDEOS x PROBE_SET_FRAMES frames,
# embedded in chunks of PROBE_EMBED_CHUNK. Then its BC policy trained on the card and on
# the CPU from the same weights and minibatches, in true f32 on both: curve and val_mse to
# rtol PROBE_BC_RTOL. At lr 1e-4 for PROBE_BC_STEPS steps: at 1e-3 Adam moves weights
# whose gradient is rounding noise by ~lr, and past ~150 steps the policy memorises the
# 108 training frames (train MSE toward 1e-3), where two f32 summation orders part (a
# 1e-7 change of the inputs moves the curve by 2e-3 at 200 steps on the CPU, by 2e-6 at
# 100).
PROBE_VIDEOS = 32
PROBE_FRAMES = 20
PROBE_STEPS = 30
PROBE_CLIPS = 16
PROBE_SET_VIDEOS = 12
PROBE_SET_FRAMES = 10
PROBE_EMBED_CHUNK = 120
PROBE_BC_STEPS = 100
PROBE_BC_RTOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def row(err, kernel, plain, moved: int, flops: float, dtype, library) -> dict:
    """A kernel's numbers: `moved` is the bytes the function must move (each input read
    once, each output written once), `flops` its operations."""
    b, by = bound_ms(moved, flops, dtype)
    ms, library_ms = time_ms(kernel), time_ms(library)
    return {"max_abs_err": err, "ms": ms, "plain_ms": time_ms(plain), "bound_ms": b,
            "bound_by": by, "bound_share": b / ms, "gbytes_per_s": moved / ms / 1e6,
            "library_ms": library_ms, "library_ratio": ms / library_ms}


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def ptxas_report(compiler_log: str, kernels) -> list:
    """The lines ``-Xptxas -v`` printed for the entry functions whose (mangled) names
    contain one of `kernels`."""
    lines, keep = [], False
    for line in compiler_log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            keep = any(k in line for k in kernels)
        if keep:
            lines.append(line.strip())
    return lines


def spills(report: list) -> list:
    """The non-zero stack frame, spill store and spill load sizes in ptxas lines."""
    return [m.group(0) for line in report
            for m in re.finditer(r"(\d+) bytes (stack frame|spill stores|spill loads)", line)
            if int(m.group(1))]


def check_pool(gen) -> tuple:
    """K1 at the serving and the training shape, with and without its argmax, on an input
    full of ties, timed as each path runs it (serving without the argmax, training with
    it), then K2 at the training shape; both exact. The same at the probe's shapes: its
    bf16 pretraining step (K1 with the argmax, K2) and its f32 embedding chunks."""
    from r3m_tpu_torch.ops.pool import (
        maxpool_3x3s2,
        maxpool_3x3s2_bwd,
        maxpool_3x3s2_bwd_reference,
        maxpool_3x3s2_fwd,
        maxpool_3x3s2_reference,
    )

    k1, k2 = {}, {}
    cases = [(phase, batch, dt) for phase, batch in (("serve", SERVE_BATCH),
                                                     ("train", TRAIN_BATCH))
             for dt in (torch.float32, torch.bfloat16)]
    # the probe's pretraining step (bf16, 16 clips) and its parity embedding chunks
    cases += [("probe_train", PROBE_CLIPS * FRAMES, torch.bfloat16),
              ("probe_serve", PROBE_EMBED_CHUNK, torch.float32)]
    for phase, batch, dt in cases:
        name = f"{phase}_{DT_NAMES[dt]}"
        shape = (batch, 112, 112, 64)  # the ResNet stem after conv1, NHWC
        # relu(randn).round(): ties in most windows
        x = torch.randn(shape, generator=gen, device="cuda").clamp_min(0).round().to(dt)
        y, idx = maxpool_3x3s2_fwd(x, argmax=True)
        y_only, _ = maxpool_3x3s2_fwd(x)
        ref, ref_idx = maxpool_3x3s2_reference(x)
        torch.cuda.synchronize()
        if not (torch.equal(y, ref) and torch.equal(y_only, ref)
                and torch.equal(idx, ref_idx)):
            raise AssertionError(f"K1 {name}: kernel differs from its plain version")
        argmax = phase.endswith("train")
        x_nchw = x.permute(0, 3, 1, 2)  # channels_last NCHW view of the same memory
        outs = (y, idx) if argmax else (y,)
        k1[name] = row(
            (y.float() - ref.float()).abs().max().item(),
            lambda: maxpool_3x3s2_fwd(x, argmax=argmax),
            lambda: maxpool_3x3s2_reference(x),
            nbytes(x, *outs), 9 * y.numel(), dt,
            lambda: F.max_pool2d(x_nchw, 3, 2, 1, return_indices=argmax),
        )
        log(f"K1 maxpool {name} {list(shape)}, ties: exact with and without the argmax; "
            f"timed {'with' if argmax else 'without'} it; {json.dumps(k1[name])}")
        if not argmax:
            continue

        h, w = shape[1:3]
        dy = torch.randn(y.shape, generator=gen, device="cuda").to(dt)
        dx = maxpool_3x3s2_bwd(idx, dy, h, w)
        want = maxpool_3x3s2_bwd_reference(idx, dy, h, w)
        torch.cuda.synchronize()
        if not torch.equal(dx, want):
            raise AssertionError(f"K2 {name}: kernel differs from its plain version")
        leaf = x.clone().requires_grad_(True)
        out = maxpool_3x3s2(leaf)
        if out.grad_fn is None:
            raise AssertionError("K1 under grad: the output carries no grad_fn")
        before = maxpool_3x3s2_bwd.launches
        out.backward(dy)
        if maxpool_3x3s2_bwd.launches != before + 1 or not torch.equal(leaf.grad, want):
            raise AssertionError("K1 under grad: the backward did not go through K2")
        _, lib_idx = F.max_pool2d(x_nchw, 3, 2, 1, return_indices=True)
        dy_nchw = dy.permute(0, 3, 1, 2)
        k2[name] = row(
            (dx.float() - want.float()).abs().max().item(),
            lambda: maxpool_3x3s2_bwd(idx, dy, h, w),
            lambda: maxpool_3x3s2_bwd_reference(idx, dy, h, w),
            nbytes(dy, idx, dx), 4 * dx.numel(), dt,
            lambda: torch.ops.aten.max_pool2d_with_indices_backward(
                dy_nchw, x_nchw, [3, 3], [2, 2], [1, 1], [1, 1], False, lib_idx),
        )
        log(f"K2 maxpool bwd {name} dy {list(dy.shape)} -> dx {list(shape)}: exact; "
            f"{json.dumps(k2[name])}")
        del x, y, y_only, idx, ref, ref_idx, dy, dx, want, leaf, out, lib_idx
    return k1, k2


@contextlib.contextmanager
def attention_library(lib):
    """K3 and K4 run through `lib`, a library built from another ``attention.cu``, inside."""
    from r3m_tpu_torch.ops import attention

    saved = attention._lib
    attention._lib = lambda: lib
    try:
        yield
    finally:
        attention._lib = saved


def load_parent_attention(source: str):
    """Build `source` (an earlier ``attention.cu``) with the port's flags into the build
    directory and bind its C interface."""
    import ctypes

    from r3m_tpu_torch.ops import _build
    from r3m_tpu_torch.ops.attention import bind

    out = _build._hashed_path("attention_parent", source, _build.NVCC_FLAGS)
    built = _build._compile({"attention_parent": (
        out, lambda tmp: [_build._nvcc(), *_build.NVCC_FLAGS, "-o", tmp, source])})
    return bind(ctypes.CDLL(built["attention_parent"][0]))


def parent_turns(parent, launch, outs) -> dict:
    """`launch()` (K3 or K4 on fixed inputs) through the parent's ``attention.cu`` against
    this one, whose outputs are `outs`: how far apart they are, and both timed in turns
    (parent, this, this, parent)."""
    with attention_library(parent):
        old = launch()
    torch.cuda.synchronize()
    old, outs = (x if isinstance(x, tuple) else (x,) for x in (old, outs))
    diff = max((a.float() - b.float()).abs().max().item() for a, b in zip(old, outs))
    ms = {"parent": [], "this": []}
    for who in ("parent", "this", "this", "parent"):
        with attention_library(parent) if who == "parent" else contextlib.nullcontext():
            ms[who].append(time_ms(launch))
    return {"parent_ms": ms["parent"], "this_ms": ms["this"],
            "max_abs_diff_from_parent": diff,
            "bit_equal_to_parent": all(torch.equal(a, b) for a, b in zip(old, outs))}


def check_attention(gen, parent=None) -> tuple:
    """K3 at the serving and training shapes, K4 at the training shapes, of ViT-B/32 at
    224 px (T = 50, one block a head) and at 384 px (T = 145, the head form), and K3 at
    DINOv2-g/14's serving shape (T = 261, 24 heads, key tiles), timed, with the form each
    took and, for the head forms, their blocks an SM; then both at T = 577 (768 px, key
    tiles), correctness only. The bound is the function's own work, not the
    kernels' extra passes. With `parent` (a bound library of an earlier ``attention.cu``),
    K3 at both 384 px shapes and K4 at the 384 px training shape, in bf16 and f32, also
    against the parent's, in turns."""
    from r3m_tpu_torch.ops.attention import (
        attention_bwd_path,
        attention_fwd_path,
        attention_head_blocks_per_sm,
        fused_attention,
        fused_attention_bwd,
        fused_attention_bwd_reference,
        fused_attention_fwd,
        fused_attention_reference,
    )

    d = 64
    k3, k4 = {}, {}
    for phase, b, t, h in (("serve", SERVE_BATCH, 50, 12), ("train", TRAIN_BATCH, 50, 12),
                           ("serve384", SERVE_384_BATCH, T_384, 12),
                           ("train384", TRAIN_384_CLIPS * FRAMES, T_384, 12),
                           ("dinov2_serve", SERVE_BATCH, T_DINOV2, 24),
                           ("check577", 2, 577, 12)):
        timed = phase != "check577"
        for dt in (torch.float32, torch.bfloat16):
            name = f"{phase}_{DT_NAMES[dt]}"
            q, k, v, do = (torch.randn((b, t, h * d), generator=gen, device="cuda").to(dt)
                           for _ in range(4))
            o = fused_attention_fwd(q, k, v, h)
            ref = fused_attention_reference(q, k, v, h)
            torch.cuda.synchronize()
            err = (o.float() - ref.float()).abs().max().item()
            err_l2 = rel_l2(o, ref)
            if not (err <= ATTENTION_ATOL[dt] and err_l2 <= ATTENTION_REL_L2[dt]):
                raise AssertionError(
                    f"K3 {name}: max abs error {err} (atol {ATTENTION_ATOL[dt]}) and "
                    f"relative L2 error {err_l2} ({ATTENTION_REL_L2[dt]})")
            qh, kh, vh, doh = (x.view(b, t, h, d).transpose(1, 2) for x in (q, k, v, do))
            lib = F.scaled_dot_product_attention(qh, kh, vh).transpose(1, 2).reshape(b, t, -1)
            log(f"K3 {name}: max abs difference from SDPA (informative) "
                f"{(o.float() - lib.float()).abs().max().item()}")
            flops = 2 * b * h * 2 * t * t * d
            if timed:
                k3[name] = row(err, lambda: fused_attention_fwd(q, k, v, h),
                               lambda: fused_attention_reference(q, k, v, h),
                               nbytes(q, k, v, o), flops, dt,
                               lambda: F.scaled_dot_product_attention(qh, kh, vh))
                k3[name]["rel_l2_err"] = err_l2
                k3[name]["path"] = attention_fwd_path(t, d, dt)
                if k3[name]["path"] == "head":
                    k3[name]["blocks_per_sm"] = attention_head_blocks_per_sm(t, d, dt, False)
                if parent is not None and t == T_384:
                    k3[name]["against_parent"] = parent_turns(
                        parent, lambda: fused_attention_fwd(q, k, v, h), o)
            log(f"K3 attention {name} {[b, t, h * d]} H={h}: max abs error {err} (atol "
                f"{ATTENTION_ATOL[dt]}), relative L2 {err_l2} ({ATTENTION_REL_L2[dt]}); "
                f"{json.dumps(k3.get(name))}")
            if "serve" in phase:
                continue

            path = attention_bwd_path(t, d, dt)
            log(f"K4 {name} T={t} D={d}: the {path} form")
            grads = fused_attention_bwd(q, k, v, do, h)
            want = fused_attention_bwd_reference(q, k, v, do, h)
            leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
            auto = torch.autograd.grad(fused_attention_reference(*leaves, h), leaves, do)
            torch.cuda.synchronize()
            err = max((g.float() - w.float()).abs().max().item() for g, w in zip(grads, want))
            err_l2 = max(rel_l2(g, w) for g, w in zip(grads, want))
            err_auto = max((g.float() - w.float()).abs().max().item()
                           for g, w in zip(grads, auto))
            err_l2_auto = max(rel_l2(g, w) for g, w in zip(grads, auto))
            if not (err <= ATTENTION_ATOL[dt] and err_l2 <= ATTENTION_REL_L2[dt]
                    and err_auto <= AUTOGRAD_ATOL[dt]):
                raise AssertionError(
                    f"K4 {name}: max abs error {err} (atol {ATTENTION_ATOL[dt]}) and "
                    f"relative L2 error {err_l2} ({ATTENTION_REL_L2[dt]}) against the plain "
                    f"backward, {err_auto} against autograd (atol {AUTOGRAD_ATOL[dt]})")
            out = fused_attention(*leaves, h)
            if out.grad_fn is None:
                raise AssertionError("K3 under grad: the output carries no grad_fn")
            before = fused_attention_bwd.launches
            got = torch.autograd.grad(out, leaves, do)
            if fused_attention_bwd.launches != before + 1 or not all(
                    torch.equal(a, g) for a, g in zip(got, grads)):
                raise AssertionError("K3 under grad: the backward did not go through K4")
            if not timed:
                log(f"K4 attention bwd {name} {[b, t, h * d]} H={h}: max abs error {err}, "
                    f"relative L2 {err_l2}, against autograd {err_auto}")
                continue
            lib_in = [x.detach().requires_grad_(True) for x in (qh, kh, vh)]
            lib_out = F.scaled_dot_product_attention(*lib_in)
            k4[name] = row(
                err,
                lambda: fused_attention_bwd(q, k, v, do, h),
                lambda: fused_attention_bwd_reference(q, k, v, do, h),
                nbytes(q, k, v, do, *grads), 5 * flops // 2, dt,
                lambda: torch.autograd.grad(lib_out, lib_in, doh, retain_graph=True),
            )
            k4[name]["rel_l2_err"] = err_l2
            k4[name]["path"] = path
            if path == "head":
                k4[name]["blocks_per_sm"] = attention_head_blocks_per_sm(t, d, dt, True)
            if parent is not None and phase == "train384":
                k4[name]["against_parent"] = parent_turns(
                    parent, lambda: fused_attention_bwd(q, k, v, do, h), grads)
            k4[name]["max_abs_err_vs_autograd"] = err_auto
            k4[name]["rel_l2_err_vs_autograd"] = err_l2_auto  # informative: no dU rounding
            log(f"K4 attention bwd {name} {[b, t, h * d]} H={h}: atol {ATTENTION_ATOL[dt]}, "
                f"relative L2 {ATTENTION_REL_L2[dt]} (autograd {AUTOGRAD_ATOL[dt]}); "
                f"{json.dumps(k4[name])}")
            del grads, want, leaves, auto, out, got, lib_in, lib_out
    return k3, k4


# `dense` at the widths of its bf16 callers: (rows, N, K) of DINOv2-g/14's request of 256
# frames (T = 261: q, k, v and the attention's output, one shape; the SwiGLU's weights_in
# and weights_out) and of ViT-B/32's (T = 50: q, k, v and the output; fc1; fc2).
DENSE_SHAPES = {
    "dinov2_qkvo": (SERVE_BATCH * T_DINOV2, 1536, 1536),
    "dinov2_weights_in": (SERVE_BATCH * T_DINOV2, 8192, 1536),
    "dinov2_weights_out": (SERVE_BATCH * T_DINOV2, 1536, 4096),
    "vit_qkvo": (SERVE_BATCH * 50, 768, 768),
    "vit_fc1": (SERVE_BATCH * 50, 3072, 768),
    "vit_fc2": (SERVE_BATCH * 50, 768, 3072),
}
DENSE_MAX_STEPS = 1.0  # the fused route against the unfused order, in bf16 steps
# ViT-B/32's `dense` calls a forward: q, k, v, the attention's output, fc1 and fc2 of 12
# layers, and the pooler
DENSE_PER_VIT_FORWARD = 12 * 6 + 1


def check_dense(gen) -> dict:
    """The fused `dense` product (``r3m_tpu_torch/ops/dense.py``) against the unfused order
    it replaces (the product with an f32 result, the f32 bias add, the cast back), at
    `DENSE_SHAPES`: both times, the product alone with an f32 result (the GEMM the unfused
    order starts with), the bound, and the largest difference in bf16 steps, which must
    stay within one; the same for dx at ViT-B/32's training rows; and cuBLASLt's answer to
    whether it takes an f32 bias with a bf16 output, which decided the route."""
    from r3m_tpu_torch.ops.dense import bf16_steps, cublaslt_takes_f32_bias, dense_dx, dense_fwd

    status = cublaslt_takes_f32_bias()
    rows = {"cublaslt_f32_bias_bf16_d": status == 0, "cublaslt_status": status,
            "route": "cutlass"}
    log(f"dense: cuBLASLt's heuristic for an f32 bias with a bf16 D: status {status}")
    for name, (m, n, k) in DENSE_SHAPES.items():
        x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        w = (torch.randn((n, k), generator=gen, device="cuda") * k ** -0.5).to(torch.bfloat16)
        b = torch.randn((n,), generator=gen, device="cuda")

        def unfused():
            return (torch.mm(x, w.t(), out_dtype=torch.float32) + b).to(torch.bfloat16)

        got, want = dense_fwd(x, w, b), unfused()
        steps = bf16_steps(got, want)
        bound, by = bound_ms(nbytes(x, w, b, got), 2 * m * n * k, torch.bfloat16)
        r = {"shape": [m, n, k], "fused_ms": time_ms(lambda: dense_fwd(x, w, b)),
             "unfused_ms": time_ms(unfused),
             "gemm_f32_ms": time_ms(lambda: torch.mm(x, w.t(), out_dtype=torch.float32)),
             "bound_ms": bound, "bound_by": by, "max_bf16_steps": steps}
        r["bound_share"] = bound / r["fused_ms"]
        r["unfused_over_fused"] = r["unfused_ms"] / r["fused_ms"]
        r["fused_over_gemm_f32"] = r["fused_ms"] / r["gemm_f32_ms"]
        if name.startswith("vit"):  # dx at the training step's rows
            g = torch.randn((TRAIN_BATCH * 50, n), generator=gen, device="cuda").bfloat16()

            def dx_unfused():
                return torch.mm(g, w, out_dtype=torch.float32).to(torch.bfloat16)

            r["dx_shape"] = [TRAIN_BATCH * 50, n, k]
            r["dx_max_bf16_steps"] = bf16_steps(dense_dx(g, w), dx_unfused())
            r["dx_ms"] = time_ms(lambda: dense_dx(g, w))
            r["dx_unfused_ms"] = time_ms(dx_unfused)
            steps = max(steps, r["dx_max_bf16_steps"])
            del g
        rows[name] = r
        log(f"dense {name}: {json.dumps(r)}")
        if steps > DENSE_MAX_STEPS:
            raise AssertionError(f"dense {name}: {steps} bf16 steps from the unfused order")
        del x, w, b, got, want
    return rows


# `layer_norm` at the shapes of its bf16 callers: DINOv2-g/14's request of 256 frames
# (T = 261), ViT-B/32's request of 256 frames and its training step's 320 (T = 50).
LN_SHAPES = {
    "dinov2_serve": (SERVE_BATCH * T_DINOV2, 1536),
    "vit_serve": (SERVE_BATCH * 50, 768),
    "vit_train": (TRAIN_BATCH * 50, 768),
}
LN_EPS = 1e-6
LN_COLD_BYTES = 160e6  # copies of x a timing cycles through, so that L2 (50 MB) holds none
# `layer_norm` calls: two a layer and the final one (DINOv2's on the class token's rows)
LN_PER_VIT_FORWARD = 12 * 2 + 1
LN_PER_DINOV2_REQUEST = 40 * 2 + 1
DINOV2_DENSE_PER_REQUEST = 40 * 6
DINOV2_FRAMES = 8


def cold_ms(fn, *tensors) -> float:
    """`time_ms` of ``fn(*copy)`` over copies of `tensors` taken in turn, as many as make
    `LN_COLD_BYTES`: each call reads its operands from device memory, not from L2."""
    copies = [[t.clone() for t in tensors]
              for _ in range(max(1, int(LN_COLD_BYTES // nbytes(*tensors)) + 1))]
    turn = iter(range(1 << 62))
    return time_ms(lambda: fn(*copies[next(turn) % len(copies)]))


def aten_layer_norm_f32_params() -> str:
    """What ATen's CUDA ``layer_norm`` does with f32 weight and bias and a bf16 x: rows of
    +2 and -2 (xhat exactly +1 and -1), weight 256, bias 1 + 2**-10, so that xhat * 256 +
    bias is 257.0009765625: 258 in bf16 where the bias stays f32, the tie 257 (256) where it
    is rounded to bf16 first."""
    x = torch.tensor([2.0, -2.0] * 32, device="cuda").repeat(4, 1).bfloat16()
    w = torch.full((64,), 256.0, device="cuda")
    b = torch.full((64,), 1 + 2 ** -10, device="cuda")
    try:
        y = F.layer_norm(x, (64,), w, b, 1e-12)
    except RuntimeError as e:
        return f"raises: {str(e).splitlines()[0][:160]}"
    bf16_params = F.layer_norm(x, (64,), w.bfloat16(), b.bfloat16(), 1e-12)
    return (f"runs: output {y.dtype}, y[0, 0] = {y[0, 0].item()} (bf16 parameters: "
            f"{bf16_params[0, 0].item()})")


def check_layer_norm(gen) -> dict:
    """`layer_norm`'s kernels (``r3m_tpu_torch/ops/layer_norm.py``) against their plain
    versions at `LN_SHAPES`, bf16: the forward's time, its bound (x read and y written once
    at 3.35 TB/s), the plain composition's time and ATen's ``F.layer_norm`` with the weight
    and bias cast to bf16 (the library's nearest call, which rounds them first), and its
    largest difference in bf16 steps, which must stay within one where y is not within f32
    rounding of zero (there within 2e-5 of (|x| + |mean|) * rstd * |w| + |b|); at the training shape
    the same for the backward (dx within one bf16 step off near-zero values, dw and db to
    f32 rounding); and what ATen does with f32 parameters and a bf16 x. Each timed call
    reads operands that L2 does not hold."""
    from r3m_tpu_torch.ops.dense import bf16_steps
    from r3m_tpu_torch.ops.layer_norm import (layer_norm_bwd, layer_norm_bwd_reference,
                                              layer_norm_fwd, layer_norm_reference)

    rows = {"aten_f32_params_with_bf16_x": aten_layer_norm_f32_params()}
    log(f"layer_norm: ATen's CUDA layer_norm with f32 weight and bias and a bf16 x "
        f"{rows['aten_f32_params_with_bf16_x']}")
    for name, (r, d) in LN_SHAPES.items():
        x = (torch.randn((r, d), generator=gen, device="cuda") * 3 + 0.5).bfloat16()
        w = torch.randn((d,), generator=gen, device="cuda") * 0.5 + 1
        b = torch.randn((d,), generator=gen, device="cuda") * 0.1
        wl, bl = w.bfloat16(), b.bfloat16()
        y, mean, rstd = layer_norm_fwd(x, w, b, LN_EPS)
        want, want_mean, want_rstd = layer_norm_reference(x, w, b, LN_EPS)
        # the magnitude of y's operands, (|x| + |mean|) * rstd * |w| + |b|: where y is under
        # 1e-3 of it, the statistics' f32 rounding is several bf16 steps of y, and y is held
        # to 2e-5 of it instead
        terms = ((x.float().abs() + want_mean.abs()[:, None]) * want_rstd[:, None] * w.abs()
                 + b.abs())
        off_zero = want.float().abs() > 1e-3 * terms
        bound, _ = bound_ms(nbytes(x, y, w, b), 0, torch.bfloat16)
        row = {"shape": [r, d], "ms": cold_ms(lambda x_: layer_norm_fwd(x_, w, b, LN_EPS), x),
               "bound_ms": bound, "bound_by": "bytes",
               "plain_ms": cold_ms(lambda x_: layer_norm_reference(x_, w, b, LN_EPS), x),
               "library_ms": cold_ms(lambda x_: F.layer_norm(x_, (d,), wl, bl, LN_EPS), x),
               "max_bf16_steps_off_zero": bf16_steps(y[off_zero], want[off_zero]),
               "near_zero_max_err_over_terms": torch.cat([
                   ((y.float() - want.float()).abs() / terms)[~off_zero],
                   terms.new_zeros(1)]).max().item()}
        row.update(bound_share=bound / row["ms"], library_ratio=row["ms"] / row["library_ms"],
                   plain_over_kernel=row["plain_ms"] / row["ms"])
        steps = row["max_bf16_steps_off_zero"]
        if row["near_zero_max_err_over_terms"] > 2e-5:
            raise AssertionError(f"layer_norm {name}: y off the composition: {row}")
        del terms, off_zero
        if name == "vit_train":
            g = torch.randn((r, d), generator=gen, device="cuda").bfloat16()
            dx, dw, db = layer_norm_bwd(g, x, mean, rstd, w)
            dx_, dw_, db_ = layer_norm_bwd_reference(g, x, want_mean, want_rstd, w)
            term = ((g.float() * w).abs().max() * rstd.max()).item()
            off_zero = dx_.float().abs() > 1e-4 * term
            _, m_, s_ = torch.ops.aten.native_layer_norm(x, [d], wl, bl, LN_EPS)
            bwd_bound, _ = bound_ms(nbytes(x, g, dx, w, dw, db), 0, torch.bfloat16)
            row.update(
                bwd_ms=cold_ms(lambda g_, x_: layer_norm_bwd(g_, x_, mean, rstd, w), g, x),
                bwd_bound_ms=bwd_bound,
                bwd_plain_ms=cold_ms(
                    lambda g_, x_: layer_norm_bwd_reference(g_, x_, mean, rstd, w), g, x),
                bwd_library_ms=cold_ms(
                    lambda g_, x_: torch.ops.aten.native_layer_norm_backward(
                        g_, x_, [d], m_, s_, wl, bl, [True, True, True]), g, x),
                dx_max_bf16_steps_off_zero=bf16_steps(dx[off_zero], dx_[off_zero]),
                dx_max_abs_err=(dx.float() - dx_.float()).abs().max().item(),
                dw_max_abs_err=(dw - dw_).abs().max().item(),
                db_max_abs_err=(db - db_).abs().max().item(),
                dw_abs_max=dw_.abs().max().item(), db_abs_max=db_.abs().max().item())
            row.update(bwd_bound_share=bwd_bound / row["bwd_ms"],
                       bwd_library_ratio=row["bwd_ms"] / row["bwd_library_ms"])
            steps = max(steps, row["dx_max_bf16_steps_off_zero"])
            if not ((dw - dw_).abs().max() <= 1e-4 * dw_.abs().max()
                    and (db - db_).abs().max() <= 1e-4 * db_.abs().max()):
                raise AssertionError(f"layer_norm {name}: dw or db off the plain sums: {row}")
            del g, dx, dw, db, dx_, dw_, db_, off_zero, m_, s_
        rows[name] = row
        log(f"layer_norm {name}: {json.dumps(row)}")
        if steps > 1.0:
            raise AssertionError(f"layer_norm {name}: {steps} bf16 steps from the plain version")
        del x, y, want, mean, rstd, want_mean, want_rstd
    torch.cuda.empty_cache()
    return rows


def dinov2_request() -> dict:
    """One fast request of `DINOV2_FRAMES` frames to DINOv2-g/14 with registers (seeded
    random weights drawn on the card): `layer_norm` launches its forward 81 times (two a
    layer and the final one on the class token's rows), the fused `dense` 240, K3 40."""
    from r3m_tpu_torch.models import dinov2
    from r3m_tpu_torch.models.r3m import R3MConfig, R3MEncoder

    torch.manual_seed(SEED)
    with torch.device("cuda"):
        enc = R3MEncoder(R3MConfig(size=dinov2.NAME, langweight=0.0), precision="fast")
    frames = np.random.default_rng(SEED).integers(0, 256, (DINOV2_FRAMES, 3, 224, 224),
                                                  dtype=np.uint8)
    reset_counts()
    out = enc(frames)
    torch.cuda.synchronize()
    launches = read_counts()
    want = counts(K3=40, D=DINOV2_DENSE_PER_REQUEST, LN=LN_PER_DINOV2_REQUEST)
    result = {"launches": launches, "frames": DINOV2_FRAMES, "shape": list(out.shape)}
    log(f"serve_dinov2_g14 request: {json.dumps(result)}")
    if launches != want or not torch.isfinite(out).all():
        raise AssertionError(f"serve_dinov2_g14: launches {launches}, expected {want}, or "
                             f"non-finite embeddings")
    del enc, out
    torch.cuda.empty_cache()
    return result


def counters():
    from r3m_tpu_torch.ops.attention import fused_attention_bwd, fused_attention_fwd
    from r3m_tpu_torch.ops.pool import maxpool_3x3s2_bwd, maxpool_3x3s2_fwd

    from r3m_tpu_torch.ops.dense import dense_dx, dense_fwd
    from r3m_tpu_torch.ops.layer_norm import layer_norm_bwd, layer_norm_fwd

    return {"K1": maxpool_3x3s2_fwd, "K2": maxpool_3x3s2_bwd,
            "K3": fused_attention_fwd, "K4": fused_attention_bwd,
            "D": dense_fwd, "Ddx": dense_dx, "LN": layer_norm_fwd, "LNbwd": layer_norm_bwd}


def counts(**given) -> dict:
    """Every counter of `counters` at 0 but those given."""
    return {k: given.get(k, 0) for k in counters()}


def reset_counts() -> None:
    for c in counters().values():
        c.launches = 0


def read_counts() -> dict:
    return {k: c.launches for k, c in counters().items()}


def write_model_pt(path: str, convnet: torch.nn.Module) -> None:
    """A reference-format model.pt: ``{"r3m": {"module.convnet.<key>": tensor}}``."""
    sd = {f"module.convnet.{k}": v for k, v in convnet.state_dict().items()}
    torch.save({"r3m": sd}, path)


def cosine_rows(a: torch.Tensor, b: torch.Tensor) -> np.ndarray:
    a, b = a.double().cpu().numpy(), b.double().cpu().numpy()
    return np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def serve(name: str, convnet: torch.nn.Module, out_dim: int, kernel: str,
          min_cosine: float, tmp: str, batch: int = SERVE_BATCH,
          requests: int = SERVE_REQUESTS, hw: int = 224, dense: int = 0,
          ln: int = 0) -> dict:
    """Serve `requests` of `batch` frames of `hw` px (and one of 64 240x320 frames)
    through load_r3m_from_files; return the launches and frames/s. `min_cosine` bounds
    fast against parity, row by row. The fused `dense` product must launch `dense` times a
    fast (bf16) request, and never in parity (f32); `layer_norm`'s forward `ln` times a
    request in either precision."""
    import r3m_tpu_torch

    path = os.path.join(tmp, f"{name}.pt")
    write_model_pt(path, convnet)
    rng = np.random.default_rng(SEED)
    frames = [rng.integers(0, 256, (batch, 3, hw, hw), dtype=np.uint8)
              for _ in range(requests)]
    odd = rng.integers(0, 256, (64, 3, 240, 320), dtype=np.uint8)

    reset_counts()
    out, fps, by_precision, dense_by_precision, ln_by_precision = {}, {}, {}, {}, {}
    for precision in ("parity", "fast"):
        before, dense_before = read_counts()[kernel], read_counts()["D"]
        ln_before = read_counts()["LN"]
        enc = r3m_tpu_torch.load_r3m_from_files(path, precision=precision)
        first = enc(frames[0])  # warms cuDNN's algorithm choice
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for f in frames:
            e = enc(f)
        torch.cuda.synchronize()
        fps[precision] = batch * len(frames) / (time.perf_counter() - t0)
        e_odd = enc(odd)
        for got, n in ((first, batch), (e, batch), (e_odd, len(odd))):
            if got.shape != (n, out_dim) or got.dtype != torch.float32:
                raise AssertionError(f"{name} {precision}: output {got.shape} {got.dtype}")
            if not torch.isfinite(got).all():
                raise AssertionError(f"{name} {precision}: non-finite embeddings")
        out[precision] = (first, e_odd)
        by_precision[precision] = read_counts()[kernel] - before
        dense_by_precision[precision] = read_counts()["D"] - dense_before
        ln_by_precision[precision] = read_counts()["LN"] - ln_before
        del enc
    launches = read_counts()
    if not all(by_precision.values()):
        raise AssertionError(f"{name}: a precision's serving path never launched {kernel}: "
                             f"{by_precision}")
    want = {"parity": 0, "fast": dense * (len(frames) + 2)}
    if dense_by_precision != want:
        raise AssertionError(f"{name}: the fused dense product launched {dense_by_precision} "
                             f"times, expected {want}")
    want = {p: ln * (len(frames) + 2) for p in ("parity", "fast")}
    if ln_by_precision != want:
        raise AssertionError(f"{name}: layer_norm launched {ln_by_precision} times, "
                             f"expected {want}")

    cos = min(cosine_rows(out["fast"][i], out["parity"][i]).min() for i in (0, 1))
    if not cos >= min_cosine:
        raise AssertionError(f"{name}: fast-vs-parity cosine {cos} < {min_cosine}")

    # the CUDA parity path against the CPU path (the kernels' plain versions)
    small = frames[0][:2]
    gpu = r3m_tpu_torch.load_r3m_from_files(path)(small).cpu()
    cpu = r3m_tpu_torch.load_r3m_from_files(path, device="cpu")(small)
    cos_cpu = cosine_rows(gpu, cpu).min()
    if not (cos_cpu > 0.9999 and torch.allclose(gpu, cpu, rtol=1e-3, atol=1e-3)):
        raise AssertionError(
            f"{name}: CUDA parity path disagrees with the CPU path (cosine {cos_cpu}, "
            f"max abs {(gpu - cpu).abs().max().item()})"
        )
    result = {
        "launches": launches,
        f"{kernel}_launches_by_precision": by_precision,
        "D_launches_by_precision": dense_by_precision,
        "LN_launches_by_precision": ln_by_precision,
        "requests": 2 * (1 + len(frames) + 1),
        "frames_per_s_parity": fps["parity"],
        "frames_per_s_fast": fps["fast"],
        "fast_vs_parity_cosine_min": float(cos),
        "cuda_vs_cpu_cosine_min": float(cos_cpu),
    }
    log(f"{name} serving: {json.dumps(result)}")
    return result


EXAMPLE_TRACE_FRAMES = 256
EXAMPLE_TOP_ROWS = 8


def example_phase(tmp: str) -> dict:
    """``python -m r3m_tpu_torch.example`` on the card, offline, then one traced fast
    request of `EXAMPLE_TRACE_FRAMES` frames to its random-init encoder: the op profile of
    the trace holds K1's kernel as often as K1's counter counted it in that request."""
    import io

    from r3m_tpu_torch import example, fetch
    from r3m_tpu_torch.utils.profiling import op_profile_raw, op_profile_summary, trace

    def offline(file_id, dest):
        raise OSError("chip_smoke downloads nothing")

    saved = os.environ.get("R3M_HOME"), fetch._drive_download
    os.environ["R3M_HOME"] = os.path.join(tmp, "r3m_home")  # empty: nothing is cached
    fetch._drive_download = offline
    reset_counts()
    printed = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(printed):
            rc = example.main([])
        torch.cuda.synchronize()
    finally:
        if saved[0] is None:
            os.environ.pop("R3M_HOME")
        else:
            os.environ["R3M_HOME"] = saved[0]
        fetch._drive_download = saved[1]
    example_s = time.perf_counter() - t0
    lines = printed.getvalue().splitlines()
    log("example: " + " | ".join(lines))
    if rc != 0 or lines[-1] != "[1, 2048]" or not lines[0].endswith("using random init"):
        raise AssertionError(f"example_resnet50: rc {rc}, printed {lines}")
    if read_counts()["K1"] == 0:
        raise AssertionError("example_resnet50: the example never launched K1")

    enc = example.random_init_encoder("cuda", precision="fast")
    frames = np.random.default_rng(SEED).integers(
        0, 256, (EXAMPLE_TRACE_FRAMES, 3, 224, 224), dtype=np.uint8)
    enc(frames[:8])  # folds the weights and warms cuDNN's algorithm choice
    torch.cuda.synchronize()
    log_dir = os.path.join(tmp, "example_trace")
    before = read_counts()["K1"]
    with trace(log_dir):
        e = enc(frames)
    traced_k1 = read_counts()["K1"] - before
    if e.shape != (EXAMPLE_TRACE_FRAMES, 2048) or not torch.isfinite(e).all():
        raise AssertionError(f"example_resnet50: traced request gave {tuple(e.shape)}")
    rows, total_ps = op_profile_raw(log_dir)
    pool = [r for r in rows if POOL_KERNELS[0] in r[4]]
    if traced_k1 != 1 or sum(r[3] for r in pool) != traced_k1:
        raise AssertionError(
            f"example_resnet50: K1 launched {traced_k1} times in the traced request, the "
            f"op profile counts {[(r[3], r[4]) for r in pool]}")
    top = [[frac, occ, name] for frac, _, _, occ, name in
           op_profile_summary(log_dir, top=EXAMPLE_TOP_ROWS)]
    k1_share = sum(r[0] for r in pool) / total_ps
    log(f"example_resnet50 traced fast request, top rows (share, occurrences, kernel): "
        f"{json.dumps(top)}; K1's share {k1_share}")
    result = {
        "launches": read_counts(),
        "branch": "random init",
        "example_seconds": example_s,
        "traced_frames": EXAMPLE_TRACE_FRAMES,
        "traced_k1_launches": traced_k1,
        "profile_k1_occurrences": sum(r[3] for r in pool),
        "profile_kernel_names": len(rows),
        "profile_device_ms": total_ps / 1e9,
        "k1_share": k1_share,
        "k1_ms": sum(r[0] for r in pool) / 1e9,
    }
    log(f"example_resnet50: {json.dumps(result)}")
    return result


@contextlib.contextmanager
def vit_plain_attention():
    """The ViT's attention call goes to K3's plain version, `fused_attention_reference`, on
    the same CUDA tensors, inside. Only the diagnostic below enters it: no path does."""
    from r3m_tpu_torch.models import vit
    from r3m_tpu_torch.ops.attention import fused_attention_reference

    saved = vit.fused_attention
    vit.fused_attention = fused_attention_reference
    try:
        yield
    finally:
        vit.fused_attention = saved


def fast_cosine_split(path: str) -> dict:
    """ViT-B/32's fast-vs-parity cosine on the card (the first request of `serve`, 256
    frames at 224 px) with K3, as served, and again with the fast forward's attention
    through its plain version on the same CUDA tensors: the share of the bf16 path's
    distance from parity that K3 holds, against that of the rest of the bf16 forward
    (cuBLAS's bf16 GEMMs, the bf16 residual stream). Parity runs K3 in f32 both times."""
    import r3m_tpu_torch

    frames = np.random.default_rng(SEED).integers(0, 256, (SERVE_BATCH, 3, 224, 224),
                                                  dtype=np.uint8)
    parity = r3m_tpu_torch.load_r3m_from_files(path)(frames)
    fast = r3m_tpu_torch.load_r3m_from_files(path, precision="fast")
    with_k3 = fast(frames)
    with vit_plain_attention():
        plain = fast(frames)
    if not all(torch.isfinite(e).all() for e in (parity, with_k3, plain)):
        raise AssertionError("fast_cosine_split: non-finite embeddings")
    result = {"fast_vs_parity_cosine_min_k3": float(cosine_rows(with_k3, parity).min()),
              "fast_vs_parity_cosine_min_plain_attention": float(cosine_rows(plain,
                                                                             parity).min()),
              "k3_vs_plain_attention_cosine_min": float(cosine_rows(with_k3, plain).min())}
    log(f"vit_b32 fast-vs-parity cosine, K3 against its plain version: {json.dumps(result)}")
    return result


def serve_against_parent(path: str, parent, batch: int, hw: int) -> dict:
    """The fast and the parity request of `path` (`batch` frames of `hw` px) through the
    parent's ``attention.cu`` and this one, timed in turns (parent, this, this, parent),
    SERVE_REQUESTS_PARENT requests a turn after one unmeasured: frames/s of each, whether
    the two give the same embeddings bit for bit, and how far apart they are."""
    import r3m_tpu_torch

    frames = np.random.default_rng(SEED).integers(0, 256, (batch, 3, hw, hw), dtype=np.uint8)
    result = {"requests": SERVE_REQUESTS_PARENT}
    for precision in ("fast", "parity"):
        enc = r3m_tpu_torch.load_r3m_from_files(path, precision=precision)
        fps, last = {"parent": [], "this": []}, {}
        for who in ("parent", "this", "this", "parent"):
            with attention_library(parent) if who == "parent" else contextlib.nullcontext():
                enc(frames)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(SERVE_REQUESTS_PARENT):
                    last[who] = enc(frames)
                torch.cuda.synchronize()
                fps[who].append(SERVE_REQUESTS_PARENT * batch / (time.perf_counter() - t0))
        result[precision] = {
            "parent_frames_per_s": fps["parent"], "this_frames_per_s": fps["this"],
            "bit_equal_to_parent": torch.equal(last["parent"], last["this"]),
            "max_abs_diff_from_parent": (last["parent"] - last["this"]).abs().max().item(),
            "cosine_min_to_parent": float(cosine_rows(last["parent"], last["this"]).min())}
        del enc
    return result


def train_against_parent(bert, gen, parent, dtype: str) -> dict:
    """The 384 px step in `dtype` through the parent's ``attention.cu`` and this one, timed
    only, in turns (parent, this, this, parent), TIMED_STEPS_PARENT steps a turn after the
    warm-up: the train frames/s of each."""
    fps = {"parent": [], "this": []}
    for who in ("parent", "this", "this", "parent"):
        with attention_library(parent) if who == "parent" else contextlib.nullcontext():
            _, state, step, batch = train_setup(0, bert, gen, dtype, TRAIN_384_CLIPS, 384)
            elapsed = run_steps(step, state, batch, TIMED_STEPS_PARENT)[3]
            fps[who].append(TIMED_STEPS_PARENT * TRAIN_384_CLIPS * FRAMES / elapsed)
            del state, step, batch
    torch.cuda.empty_cache()
    return {"timed_steps": TIMED_STEPS_PARENT, "parent_train_frames_per_s": fps["parent"],
            "this_train_frames_per_s": fps["this"]}


def train_batch(gen, clips: int, hw: int, vocab: int, tokens: int) -> dict:
    """A batch on the device: uint8 clips, token ids with padded tails (pad id 0), and
    two clips with an empty caption.

    Each clip blends two smooth random images A -> B over time, with the frames in the
    order the data pipeline emits them (start, goal, three ordered middle frames), so the
    TCN and language losses have something to learn within a few steps.
    """
    ends = torch.rand((2 * clips, 3, 28, 28), generator=gen, device="cuda") * 255.0
    ends = F.interpolate(ends, size=(hw, hw), mode="bilinear", align_corners=False)
    a, b = ends.permute(0, 2, 3, 1).reshape(2, clips, 1, hw, hw, 3)
    middle = torch.rand((clips, 3), generator=gen, device="cuda").sort(dim=1).values
    t = torch.cat([torch.zeros((clips, 1), device="cuda"),
                   torch.ones((clips, 1), device="cuda"), middle], dim=1)
    t = t[:, :, None, None, None]
    images = ((1.0 - t) * a + t * b).round().to(torch.uint8)
    lengths = torch.randint(tokens // 4, tokens + 1, (clips,), generator=gen, device="cuda")
    attn_mask = (torch.arange(tokens, device="cuda")[None] < lengths[:, None]).long()
    token_ids = torch.randint(1, vocab, (clips, tokens), generator=gen, device="cuda")
    lang_mask = torch.ones(clips, device="cuda")
    lang_mask[:2] = 0.0
    return {"images": images, "token_ids": token_ids * attn_mask, "attn_mask": attn_mask,
            "lang_mask": lang_mask}


def check_gradients(name: str, model: torch.nn.Module) -> int:
    """Every trainable parameter has a finite, non-zero gradient; returns their count."""
    bad = [n for n, p in model.named_parameters()
           if p.grad is None or not torch.isfinite(p.grad).all() or not (p.grad != 0).any()]
    if bad:
        raise AssertionError(f"{name}: {len(bad)} parameters without a finite, non-zero "
                             f"gradient, e.g. {bad[:5]}")
    return sum(1 for _ in model.parameters())


def train_setup(size: int, bert, gen, dtype: str, clips: int, image_size: int) -> tuple:
    """The pretraining config, a fresh state, the step and one batch of `clips` clips."""
    from r3m_tpu_torch.models.r3m import R3MConfig
    from r3m_tpu_torch.training.trainer import create_train_state, make_train_step

    cfg = R3MConfig(size=size, langweight=1.0, tcnweight=1.0, l1weight=1e-5,
                    num_negatives=3, lr=1e-4, compute_dtype=dtype, image_size=image_size)
    return (cfg, create_train_state(cfg, SEED), make_train_step(cfg, bert, doaug="rctraj"),
            train_batch(gen, clips, image_size, bert.cfg.vocab_size, LANG_LEN))


def run_steps(step, state, batch, timed_steps: int) -> tuple:
    """WARMUP_STEPS steps, then `timed_steps` timed ones on the same batch: the state,
    the last metrics, every loss and the timed steps' seconds."""
    losses = []
    for i in range(WARMUP_STEPS + timed_steps):
        if i == WARMUP_STEPS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["full_loss"]))  # waits for the step
    return state, metrics, losses, time.perf_counter() - t0


def train(name: str, size: int, bert, gen, dtype: str = "bfloat16",
          timed_steps: int = TIMED_STEPS, clips: int = TRAIN_CLIPS, image_size: int = 224,
          keep: bool = False):
    """The pretraining step at full width in `dtype`: warm-up steps, then timed steps on
    one repeated batch of `clips` clips at `image_size` px (fresh crops and negatives each
    step, from the state's generator). Returns the result, and with `keep` also
    ``(cfg, state, step, batch)``."""
    from r3m_tpu_torch.data.augment import sample_crop_params
    from r3m_tpu_torch.losses import draw_permutations

    cfg, state, step, batch = train_setup(size, bert, gen, dtype, clips, image_size)
    stats0 = {k: v.clone() for k, v in state.batch_stats.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_counts()
    state, metrics, losses, elapsed = run_steps(step, state, batch, timed_steps)
    launches = read_counts()
    steps = WARMUP_STEPS + timed_steps

    if not all(np.isfinite(losses)):
        raise AssertionError(f"{name} train: non-finite loss {losses}")
    if state.step != steps:
        raise AssertionError(f"{name} train: step {state.step} after {steps} steps")
    # bf16 ViT: every `dense` (six a layer and the pooler) on the fused route, dx too;
    # `layer_norm` in both dtypes, once a direction a call
    dense = DENSE_PER_VIT_FORWARD * steps if dtype == "bfloat16" else 0
    ln = LN_PER_VIT_FORWARD * steps
    want = (counts(K1=steps, K2=steps) if size else
            counts(K3=12 * steps, K4=12 * steps, D=dense, Ddx=dense, LN=ln, LNbwd=ln))
    if launches != want:
        raise AssertionError(f"{name} train: launches {launches}, expected {want}")
    if size and not all(not torch.equal(v, stats0[k]) for k, v in state.batch_stats.items()):
        raise AssertionError(f"{name} train: some BatchNorm statistics did not move")
    n_params = check_gradients(name, state.model)

    # Fresh crops and negatives each step make the loss of a random-init model wander;
    # with them held fixed the same batch is the same objective, and it must fall.
    perms = draw_permutations(gen, clips, cfg.num_negatives)
    crops = sample_crop_params(gen, clips, image_size, image_size)
    fixed = [float(step(state, batch, perms=perms, crops=crops)[1]["full_loss"])
             for _ in range(LEARN_STEPS)]
    if not (all(np.isfinite(fixed)) and fixed[-1] < fixed[0]):
        raise AssertionError(f"{name} train: with fixed draws the loss did not fall: {fixed}")
    result = {
        "dtype": dtype,
        "image_size": image_size,
        "launches": launches,
        "steps": steps,
        "clips": clips,
        "frames_per_step": clips * FRAMES,
        "losses": losses,
        "losses_fixed_draws": fixed,
        "metrics": {k: float(v) for k, v in metrics.items()},
        "train_frames_per_s": timed_steps * clips * FRAMES / elapsed,
        "ms_per_step": elapsed / timed_steps * 1e3,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "params_with_gradient": n_params,
    }
    log(f"{name} train: {json.dumps(result)}")
    if keep:
        return result, (cfg, state, step, batch)
    del state, step, batch
    torch.cuda.empty_cache()
    return result


def snapshot_resume(name: str, kept, gen) -> dict:
    """Save a trained state with save_train_snapshot and load it into a fresh state of
    another seed; the next step of both, with the crops and permutations held fixed, gives
    the same loss (rtol 1e-3: cuDNN need not sum in one order), through K1 and K2."""
    from r3m_tpu_torch.checkpoint import load_train_snapshot, save_train_snapshot
    from r3m_tpu_torch.data.augment import sample_crop_params
    from r3m_tpu_torch.losses import draw_permutations
    from r3m_tpu_torch.training.trainer import create_train_state

    cfg, state, step, batch = kept
    clips, hw = batch["images"].shape[0], batch["images"].shape[2]
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save_train_snapshot(tmp, state, cfg)
        save_s = time.perf_counter() - t0
        snapshot_bytes = os.path.getsize(path)
        t0 = time.perf_counter()
        fresh = load_train_snapshot(path, create_train_state(cfg, seed=1))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    perms = draw_permutations(gen, clips, cfg.num_negatives)
    crops = sample_crop_params(gen, clips, hw, hw)
    reset_counts()
    losses = [float(step(s, batch, perms=perms, crops=crops)[1]["full_loss"])
              for s in (state, fresh)]
    launches = read_counts()
    rel = abs(losses[1] - losses[0]) / abs(losses[0])
    result = {"launches": launches, "global_step": fresh.step, "loss_saved_state": losses[0],
              "loss_resumed_state": losses[1], "loss_rel_err": rel,
              "save_s": save_s, "load_s": load_s, "snapshot_bytes": snapshot_bytes}
    log(f"{name} snapshot resume: {json.dumps(result)}")
    if not (rel <= 1e-3 and fresh.step == state.step):
        raise AssertionError(f"{name}: the resumed state does not continue the saved one")
    if launches["K1"] != 2 or launches["K2"] != 2:
        raise AssertionError(f"{name} resume: launches {launches}, expected K1 = K2 = 2")
    return result


def snapshot_serve(name: str, kept) -> dict:
    """Save a trained ViT state and serve it through load_r3m_from_snapshot in fast
    precision: cosine against the live model's parity embeddings, K3 counted."""
    import r3m_tpu_torch
    from r3m_tpu_torch.checkpoint import save_train_snapshot
    from r3m_tpu_torch.models.r3m import R3MEncoder

    cfg, state, _, _ = kept
    frames = np.random.default_rng(SEED).integers(0, 256, (64, 3, 224, 224), dtype=np.uint8)
    want = R3MEncoder(cfg, state.model.convnet.state_dict())(frames)
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save_train_snapshot(tmp, state, cfg)
        save_s = time.perf_counter() - t0
        snapshot_bytes = os.path.getsize(path)
        reset_counts()
        t0 = time.perf_counter()
        enc = r3m_tpu_torch.load_r3m_from_snapshot(path, "fast")
        load_s = time.perf_counter() - t0
        got = enc(frames)
        launches = read_counts()
    cos = float(cosine_rows(got, want).min())
    result = {"launches": launches, "fast_vs_live_parity_cosine_min": cos,
              "save_s": save_s, "load_s": load_s, "snapshot_bytes": snapshot_bytes}
    log(f"{name} snapshot serve: {json.dumps(result)}")
    if not (got.shape == want.shape and torch.isfinite(got).all() and cos >= 0.9995):
        raise AssertionError(f"{name}: served snapshot cosine {cos} < 0.9995")
    if (launches["K3"] != 12 or launches["D"] != DENSE_PER_VIT_FORWARD
            or launches["LN"] != LN_PER_VIT_FORWARD):
        raise AssertionError(f"{name} snapshot serve: launches {launches}, expected K3 = 12, "
                             f"D = {DENSE_PER_VIT_FORWARD} and LN = {LN_PER_VIT_FORWARD}")
    return result


def cuda_against_cpu(size: int, image_size: int) -> dict:
    """One f32 step on the card and on the CPU from the same state, batch, permutations and
    crops; the step sets its own precision (true f32). The loss agrees to rtol 1e-4 and
    each gradient leaf to relative L2 error 1e-3: what is left is the order of f32 sums."""
    from r3m_tpu_torch.models.distilbert import DistilBert, DistilBertConfig
    from r3m_tpu_torch.models.r3m import R3MConfig, r3m_init
    from r3m_tpu_torch.training.trainer import create_train_state, make_train_step

    cfg = R3MConfig(size=size, hidden_dim=64, langweight=1.0, image_size=image_size)
    torch.manual_seed(SEED)
    bert = DistilBert(DistilBertConfig(vocab_size=100, n_layers=1, n_heads=4,
                                       hidden_dim=128, max_position_embeddings=16))
    model = r3m_init(cfg, SEED)
    g = torch.Generator().manual_seed(SEED)
    clips, hw = 4, image_size + 8
    batch = {"images": torch.randint(0, 256, (clips, FRAMES, hw, hw, 3), generator=g,
                                     dtype=torch.uint8),
             "token_ids": torch.randint(0, 100, (clips, 12), generator=g),
             "attn_mask": torch.ones((clips, 12), dtype=torch.int64),
             "lang_mask": torch.ones(clips)}
    perms = {"lang": torch.stack([torch.randperm(clips, generator=g) for _ in range(9)])
             .reshape(3, 3, clips),
             "tcn": torch.stack([torch.randperm(clips, generator=g) for _ in range(6)])
             .reshape(3, 2, clips)}
    crops = torch.tensor([[0, 0, hw, hw], [3, 5, hw - 6, hw - 9], [2, 2, hw // 2, hw // 2],
                          [1, 4, hw - 2, hw - 5]], dtype=torch.float32)
    out = {}
    for device in ("cpu", "cuda"):
        state = create_train_state(cfg, SEED, model=copy.deepcopy(model), device=device)
        step = make_train_step(cfg, copy.deepcopy(bert), doaug="rctraj", device=device)
        state, metrics = step(state, batch, perms=perms, crops=crops)
        out[device] = (float(metrics["full_loss"]),
                       {n: p.grad.cpu().double() for n, p in state.model.named_parameters()})
    (loss_cpu, g_cpu), (loss_gpu, g_gpu) = out["cpu"], out["cuda"]
    floor = 1e-4 * max(g.norm().item() for g in g_cpu.values())
    errs = {n: (g_gpu[n] - w).norm().item() / max(w.norm().item(), floor)
            for n, w in g_cpu.items()}
    worst = max(errs, key=errs.get)
    loss_rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    result = {"size": size, "image_size": image_size, "loss_cpu": loss_cpu,
              "loss_cuda": loss_gpu, "loss_rel_err": loss_rel,
              "worst_grad_leaf": worst, "worst_grad_rel_l2": errs[worst]}
    log(f"cuda vs cpu step: {json.dumps(result)}")
    if not (loss_rel <= 1e-4 and errs[worst] <= 1e-3):
        raise AssertionError(f"size {size}: the card's step disagrees with the CPU's")
    return result


def sentences() -> list:
    """32 instructions of 3 to 8 words."""
    return [f"{VERBS[i % len(VERBS)]} {OBJECTS[(i * 5) % len(OBJECTS)]}"
            for i in range(REWARD_PAIRS)]


def write_language(tmp: str, bert) -> tuple:
    """The frozen DistilBERT as a JAX-format ``distilbert.npz`` with ``bert_config``
    metadata, and a ``vocab.txt`` of the special tokens and the sentences' words."""
    from r3m_tpu_torch.checkpoint import save_snapshot
    from r3m_tpu_torch.convert import distilbert_tree

    bert_path = os.path.join(tmp, "distilbert.npz")
    save_snapshot(bert_path, distilbert_tree(bert.state_dict()),
                  {"bert_config": dataclasses.asdict(bert.cfg)})
    words = sorted({w for s in sentences() for w in s.split()})
    vocab_path = os.path.join(tmp, "vocab.txt")
    with open(vocab_path, "w") as f:
        f.write("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", *words]) + "\n")
    return bert_path, vocab_path


def reward_frames() -> tuple:
    """Start and current frames of the pairs and a trajectory, uint8 in host memory."""
    rng = np.random.default_rng(SEED)
    pairs = [rng.integers(0, 256, (REWARD_PAIRS, 3, 224, 224), dtype=np.uint8)
             for _ in range(2)]
    return pairs, rng.integers(0, 256, (CURVE_FRAMES, 3, 224, 224), dtype=np.uint8)


def score(name: str, rm, kernel: str, per_query: int) -> tuple:
    """Warm-up and timed reward queries, a warm-up and a timed reward curve, then one
    stacked encode and one `get_reward` timed apart; every result is read back to the
    host. `kernel` launches `per_query` times a query (one stacked [2B] encode), counted
    over the queries. Returns the last query's rewards and the numbers."""
    (frames0, frames_t), trajectory = reward_frames()
    text = sentences()
    reset_counts()
    for i in range(REWARD_WARMUP + REWARD_QUERIES):
        if i == REWARD_WARMUP:
            t0 = time.perf_counter()
        rewards = rm(frames0, frames_t, text).cpu()
    elapsed = time.perf_counter() - t0
    launches = read_counts()
    curve = rm.reward_curve(trajectory, text[0]).cpu()  # warms the 50-frame shape
    t1 = time.perf_counter()
    curve = rm.reward_curve(trajectory, text[0]).cpu()
    curve_ms = (time.perf_counter() - t1) * 1e3
    # where a query's time goes: the stacked encode, then tokenizing, DistilBERT and the head
    both = np.concatenate([frames0, frames_t])
    t2 = time.perf_counter()
    emb = rm.embed(both)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    rm.get_reward(emb[:REWARD_PAIRS], emb[REWARD_PAIRS:], text).cpu()
    t4 = time.perf_counter()
    queries = REWARD_WARMUP + REWARD_QUERIES
    if launches[kernel] != per_query * queries:
        raise AssertionError(f"{name}: {kernel} launched {launches[kernel]} times in "
                             f"{queries} queries, expected {per_query} a query")
    if not (rewards.shape == (REWARD_PAIRS,) and curve.shape == (CURVE_FRAMES,)
            and torch.isfinite(rewards).all() and torch.isfinite(curve).all()):
        raise AssertionError(f"{name}: rewards {rewards.shape}, curve {curve.shape}, "
                             "or non-finite values")
    return rewards, {"card": card(), "launches": launches,
                     "queries_per_s": REWARD_QUERIES / elapsed,
                     "pairs_per_s": REWARD_QUERIES * REWARD_PAIRS / elapsed,
                     "ms_per_query": elapsed / REWARD_QUERIES * 1e3,
                     "reward_curve_ms": curve_ms, "encode_ms": (t3 - t2) * 1e3,
                     "language_and_head_ms": (t4 - t3) * 1e3}


def reward_gap(name: str, got: torch.Tensor, want: torch.Tensor) -> tuple:
    """Max abs difference of the card's parity rewards from the CPU's, held to
    `REWARD_CPU_SHARE` of the CPU rewards' spread; returns both."""
    spread = (want.max() - want.min()).item()
    gap = (got - want).abs().max().item()
    if not (spread > 0 and gap <= REWARD_CPU_SHARE * spread):
        raise AssertionError(f"{name}: card and CPU rewards {gap} apart, more than "
                             f"{REWARD_CPU_SHARE} of the spread {spread}")
    return gap, spread


def reward_resnet50(kept, bert, tmp: str) -> dict:
    """The bf16 ResNet-50 train state saved as an ``.npz`` and scored through
    `R3MRewardModel.from_snapshot` in parity and fast precision (K1 once a query), against
    the same snapshot scored on the CPU."""
    from r3m_tpu_torch.checkpoint import save_train_snapshot
    from r3m_tpu_torch.reward import R3MRewardModel

    cfg, state, _, _ = kept
    snap = save_train_snapshot(tmp, state, cfg, keep_step_copy=False,
                               extra_meta={"lang_max_len": LANG_LEN})
    bert_path, vocab_path = write_language(tmp, bert)
    out, rewards = {}, {}
    for precision in ("parity", "fast"):
        rm = R3MRewardModel.from_snapshot(snap, bert_path, vocab_path, precision=precision)
        if rm.lang_max_len != LANG_LEN or rm.pad_mode != "fixed":
            raise AssertionError(f"reward resnet50: {rm.lang_max_len} tokens, {rm.pad_mode}")
        rewards[precision], out[precision] = score(f"reward resnet50 {precision}", rm, "K1", 1)
        del rm
    cpu = R3MRewardModel.from_snapshot(snap, bert_path, vocab_path, device="cpu")
    (frames0, frames_t), _ = reward_frames()
    want = cpu(frames0, frames_t, sentences())
    gap, spread = reward_gap("reward resnet50", rewards["parity"], want)
    gap_fast = (rewards["fast"] - rewards["parity"]).abs().max().item()
    if not gap_fast <= REWARD_FAST_ATOL:
        raise AssertionError(f"reward resnet50: fast {gap_fast} from parity, more than "
                             f"{REWARD_FAST_ATOL}")
    result = {"launches": {k: out["parity"]["launches"][k] + out["fast"]["launches"][k]
                           for k in out["parity"]["launches"]},
              "parity": out["parity"], "fast": out["fast"], "cpu_reward_spread": spread,
              "cuda_vs_cpu_max_abs": gap, "fast_vs_parity_max_abs": gap_fast}
    log(f"reward resnet50: {json.dumps(result)}")
    return result


def reference_snapshot(path: str, kept, bert) -> str:
    """A reference-format ``snapshot.pt`` of a train state: ``module.convnet.*``,
    ``module.lang_rew.*`` and the frozen DistilBERT as ``module.lang_enc.model.*``."""
    _, state, _, _ = kept
    sd = {f"module.{k}": v.detach().cpu() for k, v in state.model.state_dict().items()}
    sd.update({f"module.lang_enc.model.{k}": v.detach().cpu()
               for k, v in bert.state_dict().items()})
    torch.save({"r3m": sd, "global_step": state.step}, path)
    return path


def reward_vit(pt: str, vocab_path: str) -> dict:
    """The f32 ViT-B/32 state as a reference ``snapshot.pt`` scored through
    `R3MRewardModel.from_torch_snapshot` with its embedded DistilBERT, parity (K3 12 times
    a query), against the CPU."""
    from r3m_tpu_torch.reward import R3MRewardModel

    rm = R3MRewardModel.from_torch_snapshot(pt, None, vocab_path)
    if rm.pad_mode != "longest" or rm.cfg.image_size != 224:
        raise AssertionError(f"reward vit_b32: {rm.pad_mode}, {rm.cfg.image_size} px")
    rewards, result = score("reward vit_b32", rm, "K3", 12)
    del rm
    cpu = R3MRewardModel.from_torch_snapshot(pt, None, vocab_path, device="cpu")
    (frames0, frames_t), _ = reward_frames()
    want = cpu(frames0, frames_t, sentences())
    result["cuda_vs_cpu_max_abs"], result["cpu_reward_spread"] = reward_gap(
        "reward vit_b32", rewards, want)
    log(f"reward vit_b32: {json.dumps(result)}")
    return result


def convert_round_trip(pt: str, tmp: str) -> dict:
    """The ViT ``snapshot.pt`` through ``convert to-native`` and ``to-torch``: every
    ``convnet`` and ``lang_rew`` tensor comes back exactly."""
    from r3m_tpu_torch import convert

    npz, back = os.path.join(tmp, "vit_native.npz"), os.path.join(tmp, "vit_back.pt")
    reset_counts()
    t0 = time.perf_counter()
    convert.main(["to-native", pt, npz])
    t1 = time.perf_counter()
    convert.main(["to-torch", npz, back])
    t2 = time.perf_counter()
    want = torch.load(pt, weights_only=True)
    got = torch.load(back, weights_only=True)
    keys = {k for k in want["r3m"] if "lang_enc" not in k}
    if set(got["r3m"]) != keys or got["global_step"] != want["global_step"]:
        raise AssertionError(f"convert: keys {sorted(set(got['r3m']) ^ keys)[:5]} differ, or "
                             f"step {got['global_step']} != {want['global_step']}")
    differ = [k for k in keys if not torch.equal(got["r3m"][k], want["r3m"][k])]
    if differ:
        raise AssertionError(f"convert: {len(differ)} tensors changed, e.g. {differ[:3]}")
    result = {"launches": read_counts(), "tensors": len(keys), "to_native_s": t1 - t0,
              "to_torch_s": t2 - t1,
              "npz_bytes": os.path.getsize(npz)}
    log(f"convert vit_b32: {json.dumps(result)}")
    return result


def embed_phase(model_pt: str, tmp: str) -> dict:
    """The embed CLI over 130 PNG files of 240x320 (two batches of 64 and a tail of 2),
    parity and fast: the paths in order, K1 once a batch, parity against `R3MEncoder` on
    the same decoded arrays and fast against parity."""
    from PIL import Image

    import r3m_tpu_torch
    from r3m_tpu_torch import embed

    folder = os.path.join(tmp, "frames")
    os.makedirs(folder)
    rng = np.random.default_rng(SEED)
    for i in range(EMBED_IMAGES):
        Image.fromarray(rng.integers(0, 256, (240, 320, 3), dtype=np.uint8)).save(
            os.path.join(folder, f"frame{i:04d}.png"))
    files = embed.collect_image_files([folder])
    batches = -(-EMBED_IMAGES // EMBED_BATCH)
    out, fps, total = {}, {}, {}
    for precision in ("parity", "fast"):
        path = os.path.join(tmp, f"embeddings_{precision}.npz")
        reset_counts()
        t0 = time.perf_counter()
        embed.main([folder, "--model-file", model_pt, "--out", path,
                    "--batch", str(EMBED_BATCH), "--precision", precision])
        fps[precision] = EMBED_IMAGES / (time.perf_counter() - t0)
        launches = read_counts()
        total = {k: total.get(k, 0) + n for k, n in launches.items()}
        if launches["K1"] != batches:
            raise AssertionError(f"embed {precision}: K1 launched {launches['K1']} times for "
                                 f"{batches} batches")
        with np.load(path) as z:
            if list(z["paths"]) != files:
                raise AssertionError(f"embed {precision}: paths out of order")
            out[precision] = torch.from_numpy(z["embeddings"])
    t0 = time.perf_counter()
    decoded = embed._load_images(files, 224)
    decode_s = time.perf_counter() - t0
    want = r3m_tpu_torch.load_r3m_from_files(model_pt)(decoded)
    cos = float(cosine_rows(out["parity"], want).min())
    cos_fast = float(cosine_rows(out["fast"], out["parity"]).min())
    if not (out["parity"].shape == (EMBED_IMAGES, 2048) and cos > 0.9999
            and cos_fast >= 0.9999):
        raise AssertionError(f"embed: cosine {cos} against the encoder (> 0.9999), fast "
                             f"{cos_fast} against parity (>= 0.9999)")
    result = {"card": card(), "launches": total, "images": EMBED_IMAGES, "batch": EMBED_BATCH,
              "decode_frames_per_s": EMBED_IMAGES / decode_s,
              "frames_per_s_parity": fps["parity"], "frames_per_s_fast": fps["fast"],
              "cosine_vs_encoder_min": cos, "fast_vs_parity_cosine_min": cos_fast}
    log(f"embed resnet50: {json.dumps(result)}")
    return result


def decoder_check(root: str) -> dict:
    """The native decoder against PIL on the dataset's first frames, where the native
    library built: max and mean abs difference (the mean within `DECODE_MEAN_ATOL`), and
    each decoder's frames/s on this host (native on one thread a core, PIL on one)."""
    from r3m_tpu_torch.data.decoder import JpegDecoder, decoder_status

    paths = sorted(os.path.join(d, f) for d, _, files in os.walk(root)
                   for f in files if f.endswith(".jpg"))[:DECODE_CHECK_FRAMES]
    dec = JpegDecoder(224, 224)
    t0 = time.perf_counter()
    pil = dec._decode_batch_pil(paths, np.empty((len(paths), 224, 224, 3), np.uint8))
    result = {"frames": len(paths), "pil_frames_per_s": len(paths) / (time.perf_counter() - t0)}
    if not dec.native:
        result["native"] = f"not built: {decoder_status()[1]}"
        log(f"decoders: {json.dumps(result)}")
        return result
    t0 = time.perf_counter()
    native = dec.decode_batch(paths)
    result["native_frames_per_s"] = len(paths) / (time.perf_counter() - t0)
    diff = np.abs(native.astype(np.int16) - pil.astype(np.int16))
    result.update(max_abs=int(diff.max()), mean_abs=float(diff.mean()))
    log(f"decoders: {json.dumps(result)}")
    if not result["mean_abs"] <= DECODE_MEAN_ATOL:
        raise AssertionError(f"native and PIL decoders {result['mean_abs']} grey levels apart "
                             f"on average (at most {DECODE_MEAN_ATOL})")
    return result


def ego4d_train(bert, tmp: str, device_only: dict) -> dict:
    """`Workspace` over an Ego4D-layout dataset at the README's settings: phase A trains
    from scratch, phase B auto-resumes from A's last snapshot; delivered frames/s and the
    input wait over each phase's steps after its first `EGO4D_WARMUP`."""
    from r3m_tpu_torch.data.decoder import decoder_status
    from r3m_tpu_torch.data.ego4d import write_synthetic_dataset
    from r3m_tpu_torch.training.workspace import Workspace
    from r3m_tpu_torch.utils.config import load_config

    t0 = time.perf_counter()
    root = write_synthetic_dataset(os.path.join(tmp, "ego4d"), n_videos=EGO4D_VIDEOS,
                                   size=224, seed=SEED, captions=[f"C {s}" for s in sentences()])
    write_s = time.perf_counter() - t0
    bert_path, vocab_path = write_language(tmp, bert)
    work = os.path.join(tmp, "ego4d_run")
    config = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cfgs", "config_rep.yaml")

    def workspace(steps: int):
        cfg = load_config(config, overrides=[
            f"datapath={root}", f"log_dir={work}", "agent.size=50", "agent.langweight=1.0",
            "doaug=rctraj", "compute_dtype=bfloat16", f"batch_size={TRAIN_CLIPS}",
            f"num_workers={os.cpu_count()}", f"eval_freq={EGO4D_EVAL_FREQ}",
            f"train_steps={steps}", f"bert_weights={bert_path}", f"vocab_path={vocab_path}",
            f"lang_max_len={LANG_LEN}", "n_devices=1"])
        t = time.perf_counter()
        ws = Workspace(cfg)
        start_s = time.perf_counter() - t
        windows = []  # (steps, wall seconds with the metrics' read-back, input wait seconds,
        #               seconds queueing the steps)
        flush = ws._flush_train_metrics

        def timed_flush(pending, win_t0=None):
            flush(pending, win_t0)
            if pending and win_t0:
                windows.append(([p[0] for p in pending], time.time() - win_t0,
                                sum(p[2] for p in pending), sum(p[3] for p in pending)))

        ws._flush_train_metrics = timed_flush
        return ws, start_s, windows

    reset_counts()
    ws, start_a, windows_a = workspace(EGO4D_STEPS_A)
    try:
        ws.train()
        t = time.perf_counter()
        ws.save_snapshot()
        ws.flush_snapshots()
        snapshot_s = time.perf_counter() - t
    finally:
        ws.close()
    ws, start_b, windows_b = workspace(EGO4D_STEPS_A + EGO4D_STEPS_B)
    try:
        resumed = (ws.global_step, ws._train_stream_pos0)
        ws.train()
    finally:
        ws.close()
    launches = read_counts()
    evals = ws._val_batches  # A's, restored from its snapshot, and B's
    steps = EGO4D_STEPS_A + EGO4D_STEPS_B

    if resumed != (EGO4D_STEPS_A, EGO4D_STEPS_A):
        raise AssertionError(f"ego4d: resumed at (step, stream) {resumed}, expected "
                             f"{(EGO4D_STEPS_A, EGO4D_STEPS_A)}")
    if ws.global_step != steps:
        raise AssertionError(f"ego4d: step {ws.global_step} after phase B, expected {steps}")
    want = counts(K1=steps + evals, K2=steps)
    if launches != want:
        raise AssertionError(f"ego4d: launches {launches}, expected {want}")

    def rows(name):
        with open(os.path.join(work, name)) as f:
            return list(csv.DictReader(f))

    train_rows, eval_rows = rows("train.csv"), rows("eval.csv")
    train_steps = [int(float(r["step"])) for r in train_rows]
    eval_steps = [int(float(r["step"])) for r in eval_rows]
    losses = [float(r["full_loss"]) for r in train_rows + eval_rows]
    if not (train_steps == [10, 20, 25, 30, 35] and eval_steps == [1, 11, 21, 31]
            and np.isfinite(losses).all()):
        raise AssertionError(f"ego4d: train.csv steps {train_steps}, eval.csv steps "
                             f"{eval_steps}, losses {losses}")

    steady = [w for w in windows_a if min(w[0]) > EGO4D_WARMUP] + [
        w for w in windows_b if min(w[0]) > EGO4D_STEPS_A + EGO4D_WARMUP]
    n_steady = sum(len(w[0]) for w in steady)
    wall = sum(w[1] for w in steady)
    decoder, why = decoder_status()
    result = {
        "card": card(), "launches": launches, "decoder": decoder, "decoder_fallback_reason": why,
        "host_cores": os.cpu_count(), "host_cores_usable": len(os.sched_getaffinity(0)),
        "steps": steps, "steady_steps": n_steady, "clips": TRAIN_CLIPS,
        "delivered_train_frames_per_s": n_steady * TRAIN_CLIPS * FRAMES / wall,
        "input_wait_share": sum(w[2] for w in steady) / wall,
        # the host queueing the steps (eager launches); the rest of the wall time is the
        # wait for the card at each metrics read-back
        "queue_share": sum(w[3] for w in steady) / wall,
        "ms_per_step": wall / n_steady * 1e3,
        "device_only_train_frames_per_s": device_only["train_frames_per_s"],
        "write_dataset_s": write_s, "workspace_start_s": start_a,
        "workspace_resume_s": start_b, "snapshot_s": snapshot_s,
        "final_train_loss": float(train_rows[-1]["full_loss"]),
        "eval_losses": [float(r["full_loss"]) for r in eval_rows],
    }
    log(f"ego4d_train_resnet50: decoder {decoder}" + (f" ({why})" if why else "")
        + f"; host cores {result['host_cores']}")
    log(f"ego4d_train_resnet50: {json.dumps(result)}")
    result["decoders"] = decoder_check(root)
    return result


def run_child(fn, *args, world_size: int = 1, launcher: bool = True) -> dict:
    """Run ``fn(out_path, *args)`` in `world_size` spawned ranks (`launch_local`, which
    exports a launcher's environment), or with ``launcher=False`` in one spawned process
    with none; returns what rank 0 wrote to ``out_path`` as JSON, the other ranks' under
    ``"ranks"``. The process group lives and dies with the children."""
    from r3m_tpu_torch.parallel.mesh import launch_local

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank%d.json")
        if launcher:
            launch_local(fn, world_size, out, *args, timeout=CHILD_TIMEOUT_S)
        else:
            proc = torch.multiprocessing.get_context("spawn").Process(
                target=fn, args=(out, *args))
            proc.start()
            proc.join(CHILD_TIMEOUT_S)
            if proc.is_alive():
                proc.kill()
                proc.join()
            if proc.exitcode != 0:
                raise AssertionError(f"{fn.__name__}: the child exited with {proc.exitcode}")
        results = []
        for r in range(world_size):
            with open(out % r) as f:
                results.append(json.load(f))
    result = results[0]
    if world_size > 1:
        result["ranks"] = results[1:]
    return result


def profile_steps(step, state, batch, n: int = 2) -> dict:
    """`n` steps under torch.profiler after one unprofiled: device ms a step (the sum of
    the card's kernel times), kernels launched a step, wall ms a step (profiled), and the
    heaviest kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    state, _ = step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    return {"device_ms_per_step": sum(e.self_device_time_total for e in kernels) / 1e3 / n,
            "kernels_per_step": sum(e.count for e in kernels) / n,
            "wall_ms_per_step": wall / n * 1e3,
            "top_kernels": [[e.key[:60], e.self_device_time_total / 1e3 / n, e.count / n]
                            for e in kernels[:8]]}


def dp_rank() -> tuple:
    import torch.distributed as dist

    return dist.get_rank(), dist.get_world_size(), dist.get_backend()


def dp_train() -> dict:
    """``dp_train_resnet50``, in a rank of a world of 1 over NCCL: the bf16 ResNet-50 step
    of phase 6 through the data-parallel code (synced BatchNorm, gathered embeddings,
    averaged gradients) against the plain step, timed in turns (plain, dp, dp, plain; one
    state a path, both resident); then 2 profiled steps of each (device ms, kernels a
    step, the heaviest kernels); then 3 steps from one state with the draws held fixed
    through both (at lr `DP_SAME_LR`)."""
    from r3m_tpu_torch.data.augment import sample_crop_params
    from r3m_tpu_torch.losses import draw_permutations
    from r3m_tpu_torch.models.distilbert import DistilBert
    from r3m_tpu_torch.models.r3m import R3MConfig
    from r3m_tpu_torch.parallel.collectives import read_tally, reset_tally
    from r3m_tpu_torch.parallel.mesh import init_distributed
    from r3m_tpu_torch.training.trainer import create_train_state, make_train_step

    init_distributed("true")
    if dp_rank() != (0, 1, "nccl"):
        raise AssertionError(f"dp_train_resnet50: rank, world, backend {dp_rank()}")
    torch.manual_seed(SEED)
    bert = DistilBert().to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cfg = R3MConfig(size=50, langweight=1.0, tcnweight=1.0, l1weight=1e-5, num_negatives=3,
                    lr=1e-4, compute_dtype="bfloat16", image_size=224)
    batch = train_batch(gen, TRAIN_CLIPS, 224, bert.cfg.vocab_size, LANG_LEN)
    steps = {"plain": make_train_step(cfg, bert, doaug="rctraj"),
             "dp": make_train_step(cfg, bert, doaug="rctraj", mesh=True)}
    fps = {"plain": [], "dp": []}
    memory = {}
    states = {path: create_train_state(cfg, SEED) for path in steps}
    n = WARMUP_STEPS + TIMED_STEPS
    for i, path in enumerate(("plain", "dp", "dp", "plain")):
        state = states[path]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if i == 1:
            reset_counts()
            reset_tally()
        for j in range(n):
            if j == WARMUP_STEPS:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            state, metrics = steps[path](state, batch)
        loss = float(metrics["full_loss"])  # waits for the steps
        fps[path].append(TIMED_STEPS * TRAIN_BATCH / (time.perf_counter() - t0))
        memory[path] = torch.cuda.max_memory_allocated() / 1e9
        if not np.isfinite(loss):
            raise AssertionError(f"dp_train_resnet50 {path}: loss {loss}")
        if i == 2:
            launches, tally = read_counts(), read_tally()
        states[path] = state
    if launches != counts(K1=2 * n, K2=2 * n):
        raise AssertionError(f"dp_train_resnet50: launches {launches} in {2 * n} steps")

    profiles = {path: profile_steps(step, states[path], batch) for path, step in steps.items()}
    del states, state
    torch.cuda.empty_cache()
    perms = draw_permutations(gen, TRAIN_CLIPS, cfg.num_negatives)
    crops = sample_crop_params(gen, TRAIN_CLIPS, 224, 224)
    slow = dataclasses.replace(cfg, lr=DP_SAME_LR)
    losses = {}
    for path, mesh in (("plain", None), ("dp", True)):
        state = create_train_state(slow, SEED)
        step = make_train_step(slow, bert, doaug="rctraj", mesh=mesh)
        losses[path] = [float(step(state, batch, perms=perms, crops=crops)[1]["full_loss"])
                        for _ in range(DP_SAME_STEPS)]
        del state
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["dp"], losses["plain"]))
    plain, dp = np.mean(fps["plain"]), np.mean(fps["dp"])
    result = {
        "card": card(), "launches": launches, "steps": 2 * n, "clips": TRAIN_CLIPS,
        "plain_train_frames_per_s": fps["plain"], "dp_train_frames_per_s": fps["dp"],
        "dp_over_plain": dp / plain,
        "max_memory_allocated_gb": memory,
        "collectives_per_step": {k: {"calls": v["calls"] / (2 * n),
                                     "bytes": v["bytes"] / (2 * n)} for k, v in tally.items()},
        "profiles": profiles,
        "losses_fixed_draws": losses, "lr_fixed_draws": DP_SAME_LR,
        "loss_max_rel_err": rel, "loss_rtol": DP_BF16_LOSS_RTOL,
    }
    log(f"dp_train_resnet50: {json.dumps(result)}")
    if not rel <= DP_BF16_LOSS_RTOL:
        raise AssertionError(f"dp_train_resnet50: losses {rel} apart (rtol {DP_BF16_LOSS_RTOL})")
    return result


def dp_gloo2_child(out: str) -> None:
    """``dp_train_gloo2``: one of two gloo ranks on ``cuda:0``. Each f32 step (ResNet-18 at
    64 px, 64 clips; ViT-B/32 at 224 px, 16 clips) takes this rank's half of one global
    batch (`local_rows`); rank 0 first runs the plain step on the whole batch from the
    same state, and holds the data-parallel step to it: the loss (rtol 1e-4), every
    parameter after one Adam update at lr 1e-6 (relative L2 1e-3 a leaf, floored at 1e-4
    of the global norm: a leaf whose gradient is rounding noise moves by +-lr either way),
    the BatchNorm statistics (rtol 1e-4), the gradients' global norm (rtol 1e-2, which a
    W-times scaling would miss by far); the worst gradient leaf is printed. A ReLU input
    within rounding of 0 moves the leaves upstream of it by ~3e-3, so a gradient leaf is
    not held to 1e-3."""
    from r3m_tpu_torch.models.distilbert import DistilBert, DistilBertConfig
    from r3m_tpu_torch.models.r3m import R3MConfig
    from r3m_tpu_torch.parallel.mesh import init_distributed, local_rows
    from r3m_tpu_torch.training.trainer import create_train_state, make_train_step

    init_distributed("true", backend="gloo", device="cuda:0")
    rank, world, backend = dp_rank()
    if (world, backend) != (2, "gloo"):
        raise AssertionError(f"dp_train_gloo2: world {world}, backend {backend}")
    result = {"launches": counts()}
    for name, size, hw, clips in (("resnet18_64", 18, 64, 64), ("vit_b32_224", 0, 224, 16)):
        cfg = R3MConfig(size=size, langweight=1.0, tcnweight=1.0, l1weight=1e-5,
                        num_negatives=3, lr=1e-6, compute_dtype="float32", image_size=hw)
        torch.manual_seed(SEED)
        bert = DistilBert(DistilBertConfig(vocab_size=100, n_layers=1, n_heads=4,
                                           hidden_dim=128, max_position_embeddings=LANG_LEN))
        bert = bert.to("cuda")
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        batch = train_batch(gen, clips, hw, 100, LANG_LEN)
        rows = torch.as_tensor(local_rows(clips, 1, world, rank), device="cuda")
        if rank == 0:
            ref = create_train_state(cfg, SEED)
            ref, ref_m = make_train_step(cfg, bert, doaug="rctraj")(ref, batch)
        state = create_train_state(cfg, SEED)
        step = make_train_step(cfg, bert, doaug="rctraj", mesh=True)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, {k: v[rows] for k, v in batch.items()})
        loss = float(metrics["full_loss"])
        step_s = time.perf_counter() - t0
        result["launches"] = {k: result["launches"][k] + v for k, v in read_counts().items()}
        entry = {"loss_hex": loss.hex(), "loss": loss, "step_s": step_s}
        if rank == 0:
            sd, want = state.model.state_dict(), ref.model.state_dict()
            grads = {n: p.grad for n, p in state.model.named_parameters()}
            want_g = {n: p.grad for n, p in ref.model.named_parameters()}
            floor = 1e-4 * torch.linalg.vector_norm(
                torch.stack([w.float().norm() for w in want.values()])).item()
            gfloor = 1e-4 * float(ref_m["grad_norm"])
            errs = {k: ((sd[k].float() - w.float()).norm().item() / max(w.float().norm().item(),
                                                                        floor))
                    for k, w in want.items() if not k.endswith(("running_mean", "running_var",
                                                                "num_batches_tracked"))}
            stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
            stats_bad = [k for k in stats if not torch.allclose(sd[k], want[k], rtol=1e-4,
                                                                 atol=1e-6)]
            gerrs = {k: (grads[k] - w).norm().item() / max(w.norm().item(), gfloor)
                     for k, w in want_g.items()}
            worst, gworst = max(errs, key=errs.get), max(gerrs, key=gerrs.get)
            entry.update(
                reference_loss=float(ref_m["full_loss"]),
                loss_rel_err=abs(loss - float(ref_m["full_loss"])) / abs(float(ref_m["full_loss"])),
                worst_param=worst, worst_param_rel_l2=errs[worst], bn_statistics=len(stats),
                bn_statistics_off=stats_bad, grad_norm=float(metrics["grad_norm"]),
                reference_grad_norm=float(ref_m["grad_norm"]), worst_grad_leaf=gworst,
                worst_grad_rel_l2=gerrs[gworst])
            entry["grad_norm_rel_err"] = (abs(entry["grad_norm"] - entry["reference_grad_norm"])
                                          / entry["reference_grad_norm"])
            log(f"dp_train_gloo2 {name}: {json.dumps(entry)}")
            if not (entry["loss_rel_err"] <= 1e-4 and errs[worst] <= 1e-3 and not stats_bad
                    and entry["grad_norm_rel_err"] <= 1e-2):
                raise AssertionError(f"dp_train_gloo2 {name}: the world-2 step differs from "
                                     f"the world-1 step: {entry}")
            del ref
        result[name] = entry
        del state, step, bert
        torch.cuda.empty_cache()
    with open(out % rank, "w") as f:
        json.dump(result, f)


def ego4d_dp(root: str, bert_path: str, vocab_path: str, work: str) -> dict:
    """``ego4d_train_dp``: `Workspace` with ``distributed_init=true`` in a process no
    launcher started, so it joins a world of 1 over NCCL itself, on the dataset of
    phase 12 for `EGO4D_DP_STEPS` steps of `EGO4D_DP_CLIPS` clips with one eval and one
    snapshot."""
    import contextlib
    import io

    from r3m_tpu_torch.training.workspace import Workspace
    from r3m_tpu_torch.utils.config import load_config

    config = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cfgs", "config_rep.yaml")
    cfg = load_config(config, overrides=[
        f"datapath={root}", f"log_dir={work}", "agent.size=50", "agent.langweight=1.0",
        "doaug=rctraj", "compute_dtype=bfloat16", f"batch_size={EGO4D_DP_CLIPS}",
        f"num_workers={os.cpu_count()}", f"eval_freq={EGO4D_DP_STEPS}",
        f"train_steps={EGO4D_DP_STEPS}", f"bert_weights={bert_path}",
        f"vocab_path={vocab_path}", f"lang_max_len={LANG_LEN}", "n_devices=1",
        "distributed_init=true"])
    reset_counts()
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        ws = Workspace(cfg)
    start_s = time.perf_counter() - t0
    log(printed.getvalue().rstrip())
    try:
        t0 = time.perf_counter()
        ws.train()
        train_s = time.perf_counter() - t0
    finally:
        ws.close()
    launches = read_counts()
    snapshots = sorted(f for f in os.listdir(work) if re.fullmatch(r"snapshot_\d+\.npz", f))
    with open(os.path.join(work, "train.csv")) as f:
        rows = list(csv.DictReader(f))
    result = {"card": card(), "launches": launches, "rank_world_backend": list(dp_rank()),
              "steps": ws.global_step, "workspace_start_s": start_s, "train_s": train_s,
              "snapshots": snapshots, "train_csv_rows": len(rows),
              "final_train_loss": float(rows[-1]["full_loss"])}
    log(f"ego4d_train_dp: {json.dumps(result)}")
    line = "[distributed] rank 0/1 (nccl, cuda:0"
    want = counts(K1=EGO4D_DP_STEPS + 1, K2=EGO4D_DP_STEPS)
    if not (line in printed.getvalue() and ws.global_step == EGO4D_DP_STEPS
            and snapshots == ["snapshot_1.npz"] and rows and launches == want
            and np.isfinite(result["final_train_loss"])):
        raise AssertionError(f"ego4d_train_dp: {result}; expected launches {want}, one "
                             f"snapshot, the line {line!r}")
    return result


def dp_conv_saved() -> dict:
    """``dp_train_resnet50_conv_saved``, in the world of 1 over NCCL that ``ego4d_train_dp``
    joined: the bf16 ResNet-50 step of ``dp_train_resnet50`` through the data-parallel code
    with remat "none" and "conv_saved", one step each after one that compares the
    generators: the collectives of the step (calls and bytes by kind, `TALLY`) are the
    same, since the backward of conv_saved issues no BatchNorm all-reduce again; K1 and K2
    once in the conv_saved step."""
    from r3m_tpu_torch.models.distilbert import DistilBert
    from r3m_tpu_torch.models.r3m import R3MConfig
    from r3m_tpu_torch.parallel.collectives import read_tally, reset_tally
    from r3m_tpu_torch.training.trainer import create_train_state, make_train_step

    torch.manual_seed(SEED)
    bert = DistilBert().to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    batch = train_batch(gen, TRAIN_CLIPS, 224, bert.cfg.vocab_size, LANG_LEN)
    tallies = {}
    for remat in ("none", "conv_saved"):
        cfg = R3MConfig(size=50, langweight=1.0, tcnweight=1.0, l1weight=1e-5,
                        num_negatives=3, lr=1e-4, compute_dtype="bfloat16", image_size=224,
                        remat=remat)
        state = create_train_state(cfg, SEED)
        step = make_train_step(cfg, bert, doaug="rctraj", mesh=True)
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        reset_tally()
        reset_counts()
        state, metrics = step(state, batch)
        loss = float(metrics["full_loss"])
        tallies[remat] = read_tally()
        launches = read_counts()
        if not np.isfinite(loss):
            raise AssertionError(f"dp_train_resnet50_conv_saved {remat}: loss {loss}")
        del state, step
    result = {"launches": launches, "collectives_per_step": tallies}
    log(f"dp_train_resnet50_conv_saved: {json.dumps(result)}")
    if tallies["conv_saved"] != tallies["none"]:
        raise AssertionError(f"dp_train_resnet50_conv_saved: collectives {tallies}")
    if launches != counts(K1=1, K2=1):
        raise AssertionError(f"dp_train_resnet50_conv_saved: launches {launches}")
    return result


def dp_world1_child(out: str, root: str, bert_path: str, vocab_path: str, work: str) -> None:
    """The world-1 data-parallel phases in one process that no launcher started (one CUDA
    context and one NCCL communicator for all): ``ego4d_train_dp`` first, whose
    `Workspace` joins the world itself, then ``dp_train_resnet50`` and
    ``dp_train_resnet50_conv_saved`` in it."""
    result = {"ego4d_train_dp": ego4d_dp(root, bert_path, vocab_path, work),
              "dp_train_resnet50": dp_train()}
    torch.cuda.empty_cache()
    result["dp_train_resnet50_conv_saved"] = dp_conv_saved()
    with open(out % 0, "w") as f:
        json.dump(result, f)


def flat_grads(model: torch.nn.Module) -> torch.Tensor:
    return torch.cat([p.grad.float().flatten() for p in model.parameters()])


def flat_stats(state) -> torch.Tensor:
    return torch.cat([v.float().flatten() for v in state.batch_stats.values()])


def train_conv_saved(bert, gen) -> dict:
    """``train_resnet50_conv_saved``: the bf16 ResNet-50 step of ``train_resnet50`` with
    ``remat="conv_saved"``, timed in turns with the "none" step (none, conv_saved,
    conv_saved, none; warm-up and timed steps each, one state a path): train frames/s and
    peak device memory of both (the peak reset before each run), K1 and K2 once a
    conv_saved step. Then from one state with fixed draws, one step of each in bf16 and in
    f32: the loss, the gradients and the running statistics of conv_saved against "none"
    (module constants `REMAT_*`); the statistics moved once."""
    from r3m_tpu_torch.data.augment import sample_crop_params
    from r3m_tpu_torch.losses import draw_permutations
    from r3m_tpu_torch.models.r3m import R3MConfig, r3m_init
    from r3m_tpu_torch.training.trainer import create_train_state, make_train_step

    base = R3MConfig(size=50, langweight=1.0, tcnweight=1.0, l1weight=1e-5, num_negatives=3,
                     lr=1e-4, compute_dtype="bfloat16", image_size=224)
    cfgs = {remat: dataclasses.replace(base, remat=remat) for remat in ("none", "conv_saved")}
    batch = train_batch(gen, TRAIN_CLIPS, 224, bert.cfg.vocab_size, LANG_LEN)
    steps = {k: make_train_step(c, bert, doaug="rctraj") for k, c in cfgs.items()}
    states = {k: create_train_state(c, SEED) for k, c in cfgs.items()}
    fps = {k: [] for k in cfgs}
    memory = {k: [] for k in cfgs}
    n = WARMUP_STEPS + TIMED_STEPS
    for i, path in enumerate(("none", "conv_saved", "conv_saved", "none")):
        state = states[path]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if i == 1:
            reset_counts()
        for j in range(n):
            if j == WARMUP_STEPS:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            state, metrics = steps[path](state, batch)
        loss = float(metrics["full_loss"])  # waits for the steps
        fps[path].append(TIMED_STEPS * TRAIN_BATCH / (time.perf_counter() - t0))
        memory[path].append(torch.cuda.max_memory_allocated() / 1e9)
        if i == 2:
            launches = read_counts()
        if not np.isfinite(loss):
            raise AssertionError(f"train_resnet50_conv_saved {path}: loss {loss}")
    if launches != counts(K1=2 * n, K2=2 * n):
        raise AssertionError(f"train_resnet50_conv_saved: launches {launches} in {2 * n} "
                             "steps")
    if not all(not torch.equal(v, s) for v, s in zip(
            states["conv_saved"].batch_stats.values(), states["none"].batch_stats.values())):
        raise AssertionError("train_resnet50_conv_saved: the two paths' statistics agree "
                             "bit for bit after different steps")
    del states, state
    torch.cuda.empty_cache()

    perms = draw_permutations(gen, TRAIN_CLIPS, base.num_negatives)
    crops = sample_crop_params(gen, TRAIN_CLIPS, 224, 224)
    model = r3m_init(base, SEED)
    fixed = {}
    for dtype in ("bfloat16", "float32"):
        for remat, cfg in cfgs.items():
            cfg = dataclasses.replace(cfg, compute_dtype=dtype)
            state = create_train_state(cfg, SEED, model=copy.deepcopy(model))
            before = flat_stats(state)
            state, metrics = make_train_step(cfg, bert, doaug="rctraj")(
                state, batch, perms=perms, crops=crops)
            fixed[dtype, remat] = (float(metrics["full_loss"]), flat_grads(state.model),
                                   flat_stats(state), before)
            del state
    (l0, g0, s0, before), (l1, g1, s1, _) = (fixed["bfloat16", "none"],
                                             fixed["bfloat16", "conv_saved"])
    g32, g32_cs = fixed["float32", "none"][1], fixed["float32", "conv_saved"][1]
    checks = {
        "bf16_loss_rel_err": abs(l1 - l0) / abs(l0),
        "bf16_grad_rel_l2": ((g1 - g0).norm() / g0.norm()).item(),
        "bf16_none_grad_rel_l2_to_f32": ((g0 - g32).norm() / g32.norm()).item(),
        "bf16_conv_saved_grad_rel_l2_to_f32": ((g1 - g32).norm() / g32.norm()).item(),
        "bf16_grad_norm_rel_err": abs(g1.norm().item() - g0.norm().item()) / g0.norm().item(),
        "f32_loss_rel_err": abs(fixed["float32", "conv_saved"][0] - fixed["float32", "none"][0])
        / abs(fixed["float32", "none"][0]),
        "f32_grad_rel_l2": ((g32_cs - g32).norm() / g32.norm()).item(),
        "bf16_stats_share_of_update": ((s1 - s0).norm() / (s0 - before).norm()).item(),
    }
    result = {
        "card": card(), "launches": launches, "steps": 2 * n, "clips": TRAIN_CLIPS,
        "none_train_frames_per_s": fps["none"],
        "conv_saved_train_frames_per_s": fps["conv_saved"],
        "conv_saved_over_none": float(np.mean(fps["conv_saved"]) / np.mean(fps["none"])),
        "max_memory_allocated_gb": memory,
        "conv_saved_memory_over_none": float(np.mean(memory["conv_saved"])
                                             / np.mean(memory["none"])),
        "fixed_draws": checks,
    }
    log(f"train_resnet50_conv_saved: {json.dumps(result)}")
    bad = [k for k, ok in (
        ("bf16_loss_rel_err", checks["bf16_loss_rel_err"] <= DP_BF16_LOSS_RTOL),
        ("bf16_conv_saved_grad_rel_l2_to_f32", checks["bf16_conv_saved_grad_rel_l2_to_f32"]
         <= REMAT_BF16_GRAD_RATIO * checks["bf16_none_grad_rel_l2_to_f32"]),
        ("bf16_grad_norm_rel_err", checks["bf16_grad_norm_rel_err"] <= REMAT_BF16_NORM_RTOL),
        ("f32_loss_rel_err", checks["f32_loss_rel_err"] <= 1e-4),
        ("f32_grad_rel_l2", checks["f32_grad_rel_l2"] <= REMAT_F32_GRAD_REL_L2),
        ("bf16_stats_share_of_update", checks["bf16_stats_share_of_update"]
         <= REMAT_STATS_SHARE),
    ) if not ok]
    if bad:
        raise AssertionError(f"train_resnet50_conv_saved: {bad} out of bounds: {checks}")
    return result


def probe_phase(tmp: str) -> dict:
    """``probe_delta_resnet50``: ``r3m_tpu_torch.probe_delta.main`` end to end on the card
    (the reach world at 224 px, ResNet-50 at the README's settings for `PROBE_STEPS`
    steps, three random inits, the step-0 and the trained snapshot scored on a held-out
    set, caption contrast through `R3MRewardModel`): three rows with every metric finite,
    K1 and K2 launched (K2 once a step). Then the BC probe on the trained snapshot's
    embeddings, on the card and on the CPU from the same initial weights and minibatches:
    curve and val_mse to `PROBE_BC_RTOL`."""
    import r3m_tpu_torch
    from r3m_tpu_torch import probe_delta
    from r3m_tpu_torch.evalsuite.bc import _mlp_init, bc_probe

    run = os.path.join(tmp, "probe_run")
    args = ["--run", run, "--steps", str(PROBE_STEPS), "--bs", str(PROBE_CLIPS),
            "--size", "50", "--videos", str(PROBE_VIDEOS), "--frames", str(PROBE_FRAMES),
            "--probe-videos", str(PROBE_SET_VIDEOS), "--probe-frames", str(PROBE_SET_FRAMES),
            "--workers", str(os.cpu_count())]
    reset_counts()
    t0 = time.perf_counter()
    if probe_delta.main(args) != 0:
        raise AssertionError("probe_delta_resnet50: main returned non-zero")
    wall = time.perf_counter() - t0
    launches = read_counts()
    with open(os.path.join(run, "PROBE_DELTA.json")) as f:
        res = json.load(f)
    rows = res["rows"]
    keys = [m for m in probe_delta.METRICS] + ["reward_order_acc", "lang_contrast_acc"]
    finite = all(np.isfinite(r[k]) and np.isfinite(r[k + "_std"]) for r in rows for k in keys)
    if not ([r["encoder"] for r in rows] == ["random_init(x3)", "step0_snapshot", "trained"]
            and finite and res["probe_frames"] == PROBE_SET_VIDEOS * PROBE_SET_FRAMES):
        raise AssertionError(f"probe_delta_resnet50: {json.dumps(res)}")
    if not (launches["K2"] == PROBE_STEPS and launches["K1"] > PROBE_STEPS
            and launches["K3"] == launches["K4"] == 0):
        raise AssertionError(f"probe_delta_resnet50: launches {launches}")

    with np.load(os.path.join(run, f"probe_set_{PROBE_SET_VIDEOS}x{PROBE_SET_FRAMES}_224.npz")) as z:
        images, acts = z["images"], z["actions"]
    enc = r3m_tpu_torch.load_r3m_from_snapshot(os.path.join(run, "snapshot.npz"))
    emb = enc(images).cpu().numpy()
    emb = (emb - emb.mean(0)) / (emb.std() + 1e-8)
    n_train = emb.shape[0] - max(1, int(emb.shape[0] * 0.1))
    gen = torch.Generator().manual_seed(SEED)
    init = [{"w": layer.weight.detach().T.numpy(), "b": layer.bias.detach().numpy()}
            for layer in _mlp_init([emb.shape[1], 256, 256, acts.shape[1]], gen, "cpu")]
    idx = torch.randint(0, n_train, (PROBE_BC_STEPS, min(256, n_train)), generator=gen)
    bc = {}
    for device in ("cpu", "cuda"):
        t = time.perf_counter()
        bc[device] = bc_probe(lambda x: x, emb, acts, steps=PROBE_BC_STEPS, lr=1e-4,
                              val_frac=0.1, device=device, init_params=init,
                              batch_indices=idx)
        bc[device]["seconds"] = time.perf_counter() - t
    curve_err = float(np.max(np.abs(bc["cuda"]["train_mse_curve"]
                                    / bc["cpu"]["train_mse_curve"] - 1)))
    val_err = abs(bc["cuda"]["val_mse"] / bc["cpu"]["val_mse"] - 1)
    result = {
        "card": card(), "launches": launches, "wall_s": wall, "seconds": res["seconds"],
        "train_frames_per_s": res["train_frames_per_s"], "steps": PROBE_STEPS,
        "scored_snapshot_step": res["scored_snapshot_step"], "rows": rows,
        "bc_card_vs_cpu": {"curve_max_rel_err": curve_err, "val_mse_rel_err": val_err,
                           "val_mse": {d: bc[d]["val_mse"] for d in bc},
                           "curve_ends": {d: bc[d]["train_mse_curve"][[0, -1]].tolist()
                                          for d in bc},
                           "cuda_s": bc["cuda"]["seconds"], "cpu_s": bc["cpu"]["seconds"]},
    }
    log(f"probe_delta_resnet50: {json.dumps(result)}")
    if not (curve_err <= PROBE_BC_RTOL and val_err <= PROBE_BC_RTOL):
        raise AssertionError(f"probe_delta_resnet50: the BC probe on the card is "
                             f"{curve_err} / {val_err} from the CPU's")
    return result


def mesh_serving(tmp: str) -> dict:
    """``load_r3m_from_files(..., mesh=make_mesh(1))`` against the same encoder without a
    mesh, ResNet-50 and ViT-B/32, parity and fast, a request of 256 frames: bit-equal,
    K1 and K3 counted over the mesh's requests; then the embed CLI with ``--n-devices 1``
    against phase 4's output, bit-equal."""
    import r3m_tpu_torch
    from r3m_tpu_torch import embed
    from r3m_tpu_torch.parallel.mesh import make_mesh

    frames = np.random.default_rng(SEED + 1).integers(0, 256, (SERVE_BATCH, 3, 224, 224),
                                                      dtype=np.uint8)
    launches = counts()
    result = {}
    for name in ("resnet50", "vit_b32"):
        path = os.path.join(tmp, f"{name}.pt")
        for precision in ("parity", "fast"):
            want = r3m_tpu_torch.load_r3m_from_files(path, precision=precision)(frames)
            enc = r3m_tpu_torch.load_r3m_from_files(path, precision=precision,
                                                    mesh=make_mesh(1))
            reset_counts()
            got = enc(frames)
            torch.cuda.synchronize()
            launches = {k: launches[k] + v for k, v in read_counts().items()}
            result[f"{name}_{precision}_bit_equal"] = bool(torch.equal(got, want))
            del enc
    reset_counts()
    mesh_out = os.path.join(tmp, "embeddings_mesh.npz")
    embed.main([os.path.join(tmp, "frames"), "--model-file", os.path.join(tmp, "resnet50.pt"),
                "--out", mesh_out, "--batch", str(EMBED_BATCH), "--n-devices", "1"])
    launches = {k: launches[k] + v for k, v in read_counts().items()}
    with np.load(mesh_out) as a, np.load(os.path.join(tmp, "embeddings_parity.npz")) as b:
        result["embed_n_devices_1_bit_equal"] = bool(np.array_equal(a["embeddings"],
                                                                    b["embeddings"]))
    result["launches"] = launches
    log(f"mesh serving: {json.dumps(result)}")
    if not all(v for k, v in result.items() if k.endswith("bit_equal")):
        raise AssertionError(f"mesh serving differs from serving without a mesh: {result}")
    if not (launches["K1"] and launches["K3"]):
        raise AssertionError(f"mesh serving: launches {launches}")
    return result


class PhaseClock:
    """The seconds each phase of `main` took, logged as it ends."""

    def __init__(self):
        self.t = time.perf_counter()
        self.seconds = {}

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self.t
        log(f"[phase {name}: {now - self.t:.1f} s]")
        self.t = now


def main() -> int:
    parser = argparse.ArgumentParser(description="Drive the port on one CUDA card.")
    parser.add_argument("--parent-attention", metavar="ATTENTION_CU",
                        help="an earlier attention.cu to time K3, K4, the 384 px request "
                             "and the 384 px step against")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 1
    log(card())
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    from r3m_tpu_torch.models.distilbert import DistilBert
    from r3m_tpu_torch.models.resnet import ResNet
    from r3m_tpu_torch.models.vit import B32, ViT
    from r3m_tpu_torch.ops import _build

    t_start = time.perf_counter()
    built = _build.build()
    log(f"built {sorted(built)} in {time.perf_counter() - t_start:.1f} s")
    for name, (path, compiler_log) in built.items():
        log(f"{name}: {path}\n{compiler_log.strip()}")
    report = ptxas_report(built["attention"][1], BF16_ATTENTION_KERNELS)
    log("ptxas, bf16 attention kernels:\n" + "\n".join(report))
    for what, lib, names in (("maxpool kernels", "maxpool", POOL_KERNELS),
                             ("f32 attention kernels", "attention", F32_ATTENTION_KERNELS)):
        report = ptxas_report(built[lib][1], names)
        log(f"ptxas, {what}:\n" + "\n".join(report))
        if not report or spills(report):
            raise AssertionError(f"{what}: ptxas reports {spills(report)}")
    report = ptxas_report(built["attention"][1], BF16_NO_SPILL_KERNELS)
    if not report or spills(report):
        raise AssertionError(f"{BF16_NO_SPILL_KERNELS}: ptxas reports {spills(report)}")
    report = ptxas_report(built["dense"][1], ("GemmUniversal",))
    log("ptxas, the dense GEMMs:\n" + "\n".join(line[:160] for line in report))
    if not report or spills(report):
        raise AssertionError(f"the dense GEMMs: ptxas reports {spills(report)}")
    ln_ptxas = ptxas_report(built["layer_norm"][1], ("layer_norm",))
    log("ptxas, the layer_norm kernels:\n" + "\n".join(ln_ptxas))
    if not ln_ptxas or spills(ln_ptxas):
        raise AssertionError(f"the layer_norm kernels: ptxas reports {spills(ln_ptxas)}")
    parent = None
    if args.parent_attention:
        parent = load_parent_attention(os.path.abspath(args.parent_attention))
        log(f"parent attention.cu {args.parent_attention} built")

    clock = PhaseClock()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    k1_rows, k2_rows = check_pool(gen)
    k3_rows, k4_rows = check_attention(gen, parent)
    dense_rows = check_dense(gen)
    ln_rows = check_layer_norm(gen)
    clock("kernel checks")

    torch.manual_seed(SEED)
    resnet = ResNet(50)
    with torch.no_grad():  # non-trivial BN statistics, so the fold does real work
        for m in resnet.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5)
                m.bias.uniform_(-0.1, 0.1)
                m.running_mean.uniform_(-0.1, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    paths = {"serve_dinov2_g14": dinov2_request()}
    clock("serve_dinov2_g14")
    with tempfile.TemporaryDirectory() as tmp:
        paths["serve_resnet50"] = serve("resnet50", resnet, 2048, "K1", 0.9999, tmp)
        clock("serve_resnet50")
        del resnet
        paths["example_resnet50"] = example_phase(tmp)
        clock("example_resnet50")
        paths["embed_resnet50"] = embed_phase(os.path.join(tmp, "resnet50.pt"), tmp)
        clock("embed_resnet50")
        # ViT-B/32 in bf16 carries its residual stream in bf16 through 12 layers, as the
        # JAX package's fast path does; with these N(0, 0.02) weights both packages'
        # fast paths land at cosine ~0.9999 against parity on the CPU, so the bound is
        # looser than the ResNet's.
        paths["serve_vit_b32"] = serve("vit_b32", ViT(), 768, "K3", 0.9995, tmp,
                                       dense=DENSE_PER_VIT_FORWARD, ln=LN_PER_VIT_FORWARD)
        paths["serve_vit_b32"]["fast_cosine_split"] = fast_cosine_split(
            os.path.join(tmp, "vit_b32.pt"))
        clock("serve_vit_b32")
        # ViT-B/32 at 384 px: T = 145, K3 in its head form (bf16 fast, f32 parity)
        paths["serve_vit_b32_384"] = serve(
            "vit_b32_384", ViT(dataclasses.replace(B32, image_size=384)), 768, "K3", 0.9995,
            tmp, batch=SERVE_384_BATCH, requests=1, hw=384, dense=DENSE_PER_VIT_FORWARD,
            ln=LN_PER_VIT_FORWARD)
        clock("serve_vit_b32_384")
        if parent is not None:
            paths["serve_vit_b32_384"]["against_parent"] = serve_against_parent(
                os.path.join(tmp, "vit_b32_384.pt"), parent, SERVE_384_BATCH, 384)
            log(f"serve_vit_b32_384 against the parent's attention.cu: "
                f"{json.dumps(paths['serve_vit_b32_384']['against_parent'])}")
            clock("serve_vit_b32_384 against the parent")
        paths["mesh_serving"] = mesh_serving(tmp)
        clock("mesh_serving")

    torch.manual_seed(SEED)
    bert = DistilBert().to("cuda")  # distilbert-base geometry, seeded random weights
    with tempfile.TemporaryDirectory() as tmp:
        paths["train_resnet50"], kept = train("resnet50", 50, bert, gen, keep=True)
        clock("train_resnet50")
        paths["snapshot_resume_resnet50"] = snapshot_resume("resnet50", kept, gen)
        paths["reward_resnet50"] = reward_resnet50(kept, bert, tmp)
        clock("snapshot_resume and reward_resnet50")
        del kept
        torch.cuda.empty_cache()
        paths["train_resnet50_conv_saved"] = train_conv_saved(bert, gen)
        clock("train_resnet50_conv_saved")
        paths["ego4d_train_resnet50"] = ego4d_train(bert, tmp, paths["train_resnet50"])
        clock("ego4d_train_resnet50")
        paths["probe_delta_resnet50"] = probe_phase(tmp)
        clock("probe_delta_resnet50")
        paths["dp_train_gloo2"] = run_child(dp_gloo2_child, world_size=2)
        paths["dp_train_gloo2"]["launches"] = {
            k: v + paths["dp_train_gloo2"]["ranks"][0]["launches"][k]
            for k, v in paths["dp_train_gloo2"]["launches"].items()}
        losses = [r["resnet18_64"]["loss_hex"] + r["vit_b32_224"]["loss_hex"]
                  for r in [paths["dp_train_gloo2"], *paths["dp_train_gloo2"]["ranks"]]]
        if len(set(losses)) != 1:
            raise AssertionError(f"dp_train_gloo2: the ranks' losses differ: {losses}")
        clock("dp_train_gloo2")
        bert_path, vocab_path = write_language(tmp, bert)
        paths.update(run_child(dp_world1_child, os.path.join(tmp, "ego4d"), bert_path,
                               vocab_path, os.path.join(tmp, "ego4d_dp_run"), launcher=False))
        clock("ego4d_train_dp, dp_train_resnet50 and dp_train_resnet50_conv_saved")
        paths["train_vit_b32"] = train("vit_b32", 0, bert, gen)
        clock("train_vit_b32")
        paths["train_vit_b32_384"] = train("vit_b32_384", 0, bert, gen,
                                           timed_steps=TIMED_STEPS_384,
                                           clips=TRAIN_384_CLIPS, image_size=384)
        clock("train_vit_b32_384")
        # The same in f32: K3 and K4 in the f32 head form, true f32 set by the step itself.
        paths["train_vit_b32_384_f32"] = train("vit_b32_384_f32", 0, bert, gen, "float32",
                                               timed_steps=TIMED_STEPS_384,
                                               clips=TRAIN_384_CLIPS, image_size=384)
        clock("train_vit_b32_384_f32")
        if parent is not None:
            for name, dtype in (("train_vit_b32_384", "bfloat16"),
                                ("train_vit_b32_384_f32", "float32")):
                paths[name]["against_parent"] = train_against_parent(bert, gen, parent, dtype)
                log(f"{name} against the parent's attention.cu: "
                    f"{json.dumps(paths[name]['against_parent'])}")
            clock("train_vit_b32_384 and train_vit_b32_384_f32 against the parent")
        # The f32 step sets its own precision (true f32), whatever torch's TF32 flags say.
        paths["train_vit_b32_f32"], kept = train("vit_b32_f32", 0, bert, gen, "float32",
                                                 TIMED_STEPS_F32, keep=True)
        paths["snapshot_serve_vit_b32"] = snapshot_serve("vit_b32_f32", kept)
        clock("train_vit_b32_f32 and snapshot_serve")
        pt = reference_snapshot(os.path.join(tmp, "snapshot.pt"), kept, bert)
        del bert, kept
        torch.cuda.empty_cache()
        paths["reward_vit_b32"] = reward_vit(pt, os.path.join(tmp, "vocab.txt"))
        paths["convert_vit_b32"] = convert_round_trip(pt, tmp)
        clock("reward_vit_b32 and convert")
    for size, image_size in ((18, 32), (0, 64)):
        cuda_against_cpu(size, image_size)
    clock("cuda_against_cpu")

    def entry(key, name, source, replaces, rows):
        by_path = {p: r["launches"][key] for p, r in paths.items() if r["launches"][key]}
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(by_path.values()), "launches_by_path": by_path,
                **rows[MAIN_ROW], "shape_of_main_row": MAIN_ROW, "rows": rows}

    kernels = [
        entry("K1", "maxpool_3x3s2_fwd", "r3m_tpu_torch/csrc/maxpool.cu",
              "r3m_tpu/ops/pallas_pool.py:109", k1_rows),
        entry("K2", "maxpool_3x3s2_bwd", "r3m_tpu_torch/csrc/maxpool.cu",
              "r3m_tpu/ops/pallas_pool.py:130", k2_rows),
        entry("K3", "fused_attention_fwd", "r3m_tpu_torch/csrc/attention.cu",
              "r3m_tpu/ops/attention.py:221", k3_rows),
        entry("K4", "fused_attention_bwd", "r3m_tpu_torch/csrc/attention.cu",
              "r3m_tpu/ops/attention.py:239", k4_rows),
    ]
    # the fused dense product (bf16 ViT serving and training), which replaces no TPU kernel
    for key, name in (("D", "dense_fwd"), ("Ddx", "dense_dx")):
        by_path = {p: r["launches"][key] for p, r in paths.items() if r["launches"][key]}
        kernels.append({"name": name, "route": "cutlass", "source": "r3m_tpu_torch/csrc/dense.cu",
                        "replaces": None, "launches": sum(by_path.values()),
                        "launches_by_path": by_path, "rows": dense_rows})
    # layer_norm's kernels (ViT and DINOv2), which replace no TPU kernel
    for key, name in (("LN", "layer_norm_fwd"), ("LNbwd", "layer_norm_bwd")):
        by_path = {p: r["launches"][key] for p, r in paths.items() if r["launches"][key]}
        kernels.append({"name": name, "route": "cuda",
                        "source": "r3m_tpu_torch/csrc/layer_norm.cu", "replaces": None,
                        "launches": sum(by_path.values()), "launches_by_path": by_path,
                        "rows": ln_rows, "ptxas": ln_ptxas})
    for k in kernels:
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']}: no path launched it")
    log(f"phases (s): {json.dumps(clock.seconds)}")
    log(f"whole run {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
