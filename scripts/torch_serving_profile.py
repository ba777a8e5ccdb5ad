"""Where the port's serving time goes on the card: a torch.profiler breakdown.

    python3 scripts/torch_serving_profile.py [--batch 256] [--requests 3] [--seed 0]

For ResNet-50 and ViT-B/32 (seeded random weights, as chip_smoke.py makes them) in
parity and fast precision: one warm-up request of uint8 frames at 224 px from host
memory, a window of `--requests` requests without the profiler, then a profiled window
of as many. Prints, per cell, the wall time per request of both windows, the device time
per request (the union of kernel intervals in the profiled window), the device's busy
share of each window (that device time over the window's wall time; the profiler's host
tracing lowers the profiled one), the top device operations by self time, and the device
kernels that ran just before and just after each of the port's kernels (a layout copy
beside K1 would show there). Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import Counter

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# What the profiler's names of the port's hand kernels (csrc/*.cu) contain: K3 and K4 have
# an f32 and a bf16 template each.
PORT_KERNELS = {"K1": "maxpool3x3s2_kernel<", "K2": "maxpool3x3s2_bwd_kernel<",
                "K3": "attention_fwd_", "K4": "attention_bwd_"}


def device_kernels(prof) -> list:
    """The card's work: kernels, copies and sets. Not the device-side records that are
    none: a user annotation's span (the optimizer step's includes the idle gaps between
    its kernels) and CUPTI's own buffer requests."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.name != "Activity Buffer Request"]


def busy_ms(prof) -> float:
    """Union of the device kernels' intervals, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in device_kernels(prof))
    total, cur_s, cur_e = 0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3  # us -> ms


def neighbours(prof) -> dict:
    """For each port kernel that ran: ``{"before": {name: [count, mean us]}, "after":
    {...}}``, the device kernels that ran just before and just after its launches, in
    device order. The time tells a layout copy of an activation (tens of us and more at
    these shapes) from a cast of a weight's gradient (a few us)."""
    kernels = sorted(device_kernels(prof), key=lambda e: e.time_range.start)
    out = {}
    for key, pattern in PORT_KERNELS.items():
        sides = {"before": (Counter(), Counter()), "after": (Counter(), Counter())}
        for i, e in enumerate(kernels):
            if pattern not in e.name:
                continue
            for side, j in (("before", i - 1), ("after", i + 1)):
                if 0 <= j < len(kernels):
                    count, us = sides[side]
                    count[kernels[j].name[:70]] += 1
                    us[kernels[j].name[:70]] += kernels[j].time_range.elapsed_us()
        if any(count for count, _ in sides.values()):
            out[key] = {side: {n: [c, us[n] / c] for n, c in count.items()}
                        for side, (count, us) in sides.items()}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1

    from torch.profiler import ProfilerActivity, profile

    from r3m_tpu_torch.models.r3m import R3MConfig, R3MEncoder

    print(torch.cuda.get_device_name(0), flush=True)
    rng = np.random.default_rng(args.seed)
    frames = rng.integers(0, 256, (args.batch, 3, 224, 224), dtype=np.uint8)
    for size, name in ((50, "resnet50"), (0, "vit_b32")):
        torch.manual_seed(args.seed)
        sd = R3MEncoder(R3MConfig(size=size), device="cpu").convnet.state_dict()
        for precision in ("parity", "fast"):
            enc = R3MEncoder(R3MConfig(size=size), sd, precision=precision)
            enc(frames)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(args.requests):
                enc(frames)
            torch.cuda.synchronize()
            wall_unprofiled = (time.perf_counter() - t0) * 1e3
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(args.requests):
                    enc(frames)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            busy = busy_ms(prof)
            top = sorted(
                (e for e in prof.key_averages() if e.self_device_time_total > 0),
                key=lambda e: -e.self_device_time_total,
            )[:8]
            row = {
                "cell": f"{name}/{precision}",
                "batch": args.batch,
                "ms_per_request_unprofiled": wall_unprofiled / args.requests,
                "ms_per_request_profiled": wall / args.requests,
                "device_ms_per_request": busy / args.requests,
                "device_busy_share_unprofiled": busy / wall_unprofiled,
                "device_busy_share_profiled": busy / wall,
                "top_device_ops_ms_per_request": [
                    [e.key[:60], e.self_device_time_total / 1e3 / args.requests, e.count
                     // args.requests]
                    for e in top
                ],
                "port_kernel_neighbours": neighbours(prof),
            }
            print(json.dumps(row), flush=True)
            del enc
    return 0


if __name__ == "__main__":
    sys.exit(main())
