"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py            # from the root of a checkout; needs one CUDA card

Phases, in order; any failure ends the run with a non-zero exit and no result line:

1. print the card's name and power limit (nvidia-smi);
2. build every kernel of ``r3m_tpu_torch/csrc`` from the checkout's sources, and print
   what ``-Xptxas -v`` says of the maxpool, the bf16 and the f32 attention kernels
   (registers, shared memory, spills); the maxpool and f32 attention kernels must neither
   spill nor use a stack frame;
3. each kernel against its plain PyTorch version on the card, at the shapes the serving
   and training paths give it, f32 and bf16, with the times of the kernel, the plain
   version and one library call, and the bound:
   K1 (stem max-pool, with and without its int8 argmax, on an input full of ties) and K2
   (its backward) exact; K3 (fused attention) and K4 (its recompute-P backward) to a
   stated atol and to a relative L2 error that tells whether they round where their
   plain versions do, K4 also against autograd of K3's plain forward, at ViT-B/32's
   heads at 224 px (T = 50, one block a head) and at 384 px (T = 145, key tiles), and
   at T = 577 (768 px, correctness only); under grad a CUDA call carries a grad_fn and
   its backward is the kernel; each row also gives the kernel's time over the library
   call's (`library_ratio`), the bound over the kernel's time (`bound_share`) and the
   bytes the function must move over the kernel's time (`gbytes_per_s`);
4. ResNet-50 serving through ``load_r3m_from_files`` (seeded random weights written as a
   reference ``model.pt``), parity and fast: a few requests of 256 frames at 224 px and
   one of 240x320 frames; shapes, finiteness, fast-vs-parity cosine, agreement with the
   CPU path on a small input, and K1's launches over the served requests;
5. ViT-B/32 serving, the same, with K3's launches; then ViT-B/32 at 384 px (T = 145),
   one request of 64 frames;
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
8. the ViT-B/32 pretraining step, the same as 6, with 12 launches of K3 and of K4 a step;
   then at 384 px, 16 clips, 3 timed steps;
9. the ViT-B/32 pretraining step in f32, the same but for 5 timed steps, with no TF32
   flag set by this script (the step runs in true f32 itself): the f32 K3 and K4 at full
   width, 12 launches of each a step; then that state saved and served through
   ``load_r3m_from_snapshot`` in fast precision, against the live model in parity;
10. a small f32 step (ResNet-18 at 32 px, ViT at 64 px) on the card and on the CPU from
   the same state, batch, permutations and crops: loss and gradients agree;
11. one JSON line with every kernel's numbers, then the result line.

Each path's launch counts are set to 0 just before it runs and read just after; the
kernel checks of phase 3 are not counted. Uses no JAX: the port is checked against its
own plain versions and its CPU path.
"""

from __future__ import annotations

import copy
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
                          "attention_bwd_dkdv_bf16_kernel")
F32_ATTENTION_KERNELS = ("attention_fwd_f32_kernel", "attention_bwd_f32_kernel",
                         "attention_fwd_f32_tiled_kernel", "attention_bwd_dq_f32_kernel",
                         "attention_bwd_dkdv_f32_kernel")
# ViT-B/32 at 384 px: 12 x 12 patches and the class token, more than one block holds.
T_384 = 145
SERVE_384_BATCH = 64
TRAIN_384_CLIPS = 16
TIMED_STEPS_384 = 3


def log(msg: str) -> None:
    print(msg, flush=True)


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
    it), then K2 at the training shape; both exact."""
    from r3m_tpu_torch.ops.pool import (
        maxpool_3x3s2,
        maxpool_3x3s2_bwd,
        maxpool_3x3s2_bwd_reference,
        maxpool_3x3s2_fwd,
        maxpool_3x3s2_reference,
    )

    k1, k2 = {}, {}
    for phase, batch in (("serve", SERVE_BATCH), ("train", TRAIN_BATCH)):
        for dt in (torch.float32, torch.bfloat16):
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
            argmax = phase == "train"
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
            if phase != "train":
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


def check_attention(gen) -> tuple:
    """K3 at the serving and training shapes, K4 at the training shapes, of ViT-B/32 at
    224 px (T = 50, one block a head) and at 384 px (T = 145, key tiles), timed; then both
    at T = 577 (768 px), correctness only. The bound is the function's own work, not the
    key-tiled kernels' extra passes."""
    from r3m_tpu_torch.ops.attention import (
        fused_attention,
        fused_attention_bwd,
        fused_attention_bwd_reference,
        fused_attention_fwd,
        fused_attention_reference,
    )

    h, d = 12, 64  # ViT-B/32
    k3, k4 = {}, {}
    for phase, b, t in (("serve", SERVE_BATCH, 50), ("train", TRAIN_BATCH, 50),
                        ("serve384", SERVE_384_BATCH, T_384),
                        ("train384", TRAIN_384_CLIPS * FRAMES, T_384), ("check577", 2, 577)):
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
            log(f"K3 attention {name} {[b, t, h * d]} H={h}: max abs error {err} (atol "
                f"{ATTENTION_ATOL[dt]}), relative L2 {err_l2} ({ATTENTION_REL_L2[dt]}); "
                f"{json.dumps(k3.get(name))}")
            if phase.startswith("serve"):
                continue

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
            k4[name]["max_abs_err_vs_autograd"] = err_auto
            k4[name]["rel_l2_err_vs_autograd"] = err_l2_auto  # informative: no dU rounding
            log(f"K4 attention bwd {name} {[b, t, h * d]} H={h}: atol {ATTENTION_ATOL[dt]}, "
                f"relative L2 {ATTENTION_REL_L2[dt]} (autograd {AUTOGRAD_ATOL[dt]}); "
                f"{json.dumps(k4[name])}")
            del grads, want, leaves, auto, out, got, lib_in, lib_out
    return k3, k4


def counters():
    from r3m_tpu_torch.ops.attention import fused_attention_bwd, fused_attention_fwd
    from r3m_tpu_torch.ops.pool import maxpool_3x3s2_bwd, maxpool_3x3s2_fwd

    return {"K1": maxpool_3x3s2_fwd, "K2": maxpool_3x3s2_bwd,
            "K3": fused_attention_fwd, "K4": fused_attention_bwd}


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
          requests: int = SERVE_REQUESTS, hw: int = 224) -> dict:
    """Serve `requests` of `batch` frames of `hw` px (and one of 64 240x320 frames)
    through load_r3m_from_files; return the launches and frames/s. `min_cosine` bounds
    fast against parity, row by row."""
    import r3m_tpu_torch

    path = os.path.join(tmp, f"{name}.pt")
    write_model_pt(path, convnet)
    rng = np.random.default_rng(SEED)
    frames = [rng.integers(0, 256, (batch, 3, hw, hw), dtype=np.uint8)
              for _ in range(requests)]
    odd = rng.integers(0, 256, (64, 3, 240, 320), dtype=np.uint8)

    reset_counts()
    out, fps = {}, {}
    for precision in ("parity", "fast"):
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
        del enc
    launches = read_counts()
    if launches[kernel] == 0:
        raise AssertionError(f"{name}: the serving path never launched {kernel}")

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
        "requests": 2 * (1 + len(frames) + 1),
        "frames_per_s_parity": fps["parity"],
        "frames_per_s_fast": fps["fast"],
        "fast_vs_parity_cosine_min": float(cos),
        "cuda_vs_cpu_cosine_min": float(cos_cpu),
    }
    log(f"{name} serving: {json.dumps(result)}")
    return result


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


def train(name: str, size: int, bert, gen, dtype: str = "bfloat16",
          timed_steps: int = TIMED_STEPS, clips: int = TRAIN_CLIPS, image_size: int = 224,
          keep: bool = False):
    """The pretraining step at full width in `dtype`: warm-up steps, then timed steps on
    one repeated batch of `clips` clips at `image_size` px (fresh crops and negatives each
    step, from the state's generator). Returns the result, and with `keep` also
    ``(cfg, state, step, batch)``."""
    from r3m_tpu_torch.data.augment import sample_crop_params
    from r3m_tpu_torch.losses import draw_permutations
    from r3m_tpu_torch.models.r3m import R3MConfig
    from r3m_tpu_torch.training.trainer import create_train_state, make_train_step

    cfg = R3MConfig(size=size, langweight=1.0, tcnweight=1.0, l1weight=1e-5,
                    num_negatives=3, lr=1e-4, compute_dtype=dtype, image_size=image_size)
    state = create_train_state(cfg, SEED)
    step = make_train_step(cfg, bert, doaug="rctraj")
    batch = train_batch(gen, clips, image_size, bert.cfg.vocab_size, LANG_LEN)
    stats0 = {k: v.clone() for k, v in state.batch_stats.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_counts()
    losses = []
    for i in range(WARMUP_STEPS + timed_steps):
        if i == WARMUP_STEPS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["full_loss"]))  # waits for the step
    elapsed = time.perf_counter() - t0
    launches = read_counts()
    steps = WARMUP_STEPS + timed_steps

    if not all(np.isfinite(losses)):
        raise AssertionError(f"{name} train: non-finite loss {losses}")
    if state.step != steps:
        raise AssertionError(f"{name} train: step {state.step} after {steps} steps")
    want = ({"K1": steps, "K2": steps, "K3": 0, "K4": 0} if size else
            {"K1": 0, "K2": 0, "K3": 12 * steps, "K4": 12 * steps})
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
    if launches["K3"] != 12:
        raise AssertionError(f"{name} snapshot serve: launches {launches}, expected K3 = 12")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(smi)
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

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    k1_rows, k2_rows = check_pool(gen)
    k3_rows, k4_rows = check_attention(gen)

    torch.manual_seed(SEED)
    resnet = ResNet(50)
    with torch.no_grad():  # non-trivial BN statistics, so the fold does real work
        for m in resnet.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5)
                m.bias.uniform_(-0.1, 0.1)
                m.running_mean.uniform_(-0.1, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths["serve_resnet50"] = serve("resnet50", resnet, 2048, "K1", 0.9999, tmp)
        del resnet
        # ViT-B/32 in bf16 carries its residual stream in bf16 through 12 layers, as the
        # JAX package's fast path does; with these N(0, 0.02) weights both packages'
        # fast paths land at cosine ~0.9999 against parity on the CPU, so the bound is
        # looser than the ResNet's.
        paths["serve_vit_b32"] = serve("vit_b32", ViT(), 768, "K3", 0.9995, tmp)
        # ViT-B/32 at 384 px: T = 145, K3 in key tiles
        paths["serve_vit_b32_384"] = serve(
            "vit_b32_384", ViT(dataclasses.replace(B32, image_size=384)), 768, "K3", 0.9995,
            tmp, batch=SERVE_384_BATCH, requests=1, hw=384)

    torch.manual_seed(SEED)
    bert = DistilBert().to("cuda")  # distilbert-base geometry, seeded random weights
    paths["train_resnet50"], kept = train("resnet50", 50, bert, gen, keep=True)
    paths["snapshot_resume_resnet50"] = snapshot_resume("resnet50", kept, gen)
    del kept
    paths["train_vit_b32"] = train("vit_b32", 0, bert, gen)
    paths["train_vit_b32_384"] = train("vit_b32_384", 0, bert, gen, timed_steps=TIMED_STEPS_384,
                                       clips=TRAIN_384_CLIPS, image_size=384)
    # The f32 step sets its own precision (true f32), whatever torch's TF32 flags say.
    paths["train_vit_b32_f32"], kept = train("vit_b32_f32", 0, bert, gen, "float32",
                                             TIMED_STEPS_F32, keep=True)
    paths["snapshot_serve_vit_b32"] = snapshot_serve("vit_b32_f32", kept)
    del bert, kept
    torch.cuda.empty_cache()
    for size, image_size in ((18, 32), (0, 64)):
        cuda_against_cpu(size, image_size)

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
    for k in kernels:
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']}: no path launched it")
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
