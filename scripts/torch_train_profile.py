"""Where the port's pretraining step spends its time on the card: a torch.profiler
breakdown.

    python3 scripts/torch_train_profile.py [--steps 3] [--dtype bfloat16|float32]

For the ResNet-50 and ViT-B/32 steps in chip_smoke.py's configuration (64 clips of 5
random uint8 frames at 224 px on the device, rctraj, language + TCN + L1/L2 losses, Adam
1e-4, a frozen DistilBERT of base geometry with seeded random weights), in bf16 or in f32
with TF32 off for matmuls and cuDNN (the parity contract's f32): two warm-up steps,
a window of `--steps` steps without the profiler, then a profiled window of as many
steps. Prints, per backbone, the wall time per step of both windows, the device time per
step (the union of kernel intervals in the profiled window), the device's busy share of
each window (that device time over the window's wall time), the device time per step of
each kernel of the port and the device kernels that ran just before and just after it (a
layout copy beside K1 or K2 would show there), and the top device operations by self
time, as device kernels and as the operators that launched them. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "scripts"))

from torch_serving_profile import PORT_KERNELS, busy_ms, neighbours  # noqa: E402

CLIPS = 64  # the README's train command, as chip_smoke.py runs it
SEED = 0


def top(events, steps: int, n: int = 12) -> list:
    """``[name, device ms per step, calls per step]`` of the `n` heaviest events."""
    events = sorted(events, key=lambda e: -e.self_device_time_total)[:n]
    return [[e.key[:70], e.self_device_time_total / 1e3 / steps, e.count // steps]
            for e in events]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from r3m_tpu_torch.models.distilbert import DistilBert
    from r3m_tpu_torch.models.r3m import R3MConfig
    from r3m_tpu_torch.training.trainer import create_train_state, make_train_step

    print(torch.cuda.get_device_name(0), flush=True)
    torch.manual_seed(SEED)
    bert = DistilBert().to("cuda")
    rng = np.random.default_rng(SEED)
    batch = {
        "images": torch.from_numpy(
            rng.integers(0, 256, (CLIPS, 5, 224, 224, 3), dtype=np.uint8)).cuda(),
        "token_ids": torch.from_numpy(rng.integers(1, 30522, (CLIPS, 32))).cuda(),
        "attn_mask": torch.ones((CLIPS, 32), dtype=torch.int64, device="cuda"),
        "lang_mask": torch.ones(CLIPS, device="cuda"),
    }
    frames = CLIPS * 5
    if args.dtype == "float32":
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    for size, name in ((50, "resnet50"), (0, "vit_b32")):
        cfg = R3MConfig(size=size, langweight=1.0, tcnweight=1.0, l1weight=1e-5,
                        compute_dtype=args.dtype)
        state = create_train_state(cfg, SEED)
        step = make_train_step(cfg, bert, doaug="rctraj")
        for _ in range(2):
            state, metrics = step(state, batch)
        float(metrics["full_loss"])
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, metrics = step(state, batch)
        float(metrics["full_loss"])
        wall_unprofiled = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.steps):
                state, metrics = step(state, batch)
            float(metrics["full_loss"])
            wall = (time.perf_counter() - t0) * 1e3
        busy = busy_ms(prof)
        averages = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        kernels = {
            k: sum(e.self_device_time_total for e in averages if pattern in e.key)
            / 1e3 / args.steps
            for k, pattern in PORT_KERNELS.items()
        }
        on_device = [e for e in averages if e.device_type == DeviceType.CUDA]
        ops = [e for e in averages if e.device_type != DeviceType.CUDA]
        row = {
            "cell": f"train/{name}/{'f32' if args.dtype == 'float32' else 'bf16'}",
            "clips": CLIPS,
            "frames_per_step": frames,
            "ms_per_step_unprofiled": wall_unprofiled / args.steps,
            "ms_per_step_profiled": wall / args.steps,
            "train_frames_per_s_unprofiled": frames * args.steps / (wall_unprofiled / 1e3),
            "device_ms_per_step": busy / args.steps,
            "device_busy_share_unprofiled": busy / wall_unprofiled,
            "device_busy_share_profiled": busy / wall,
            "port_kernels_ms_per_step": kernels,
            "port_kernel_neighbours": neighbours(prof),
            # Device kernels by name, and the operators that launched them (one
            # kernel's time shows in both lists).
            "top_kernels_ms_per_step": top(on_device, args.steps),
            "top_ops_device_ms_per_step": top(ops, args.steps),
        }
        print(json.dumps(row), flush=True)
        del state, step
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
