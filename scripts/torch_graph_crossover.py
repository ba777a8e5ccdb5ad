"""Eager against graphed requests of `R3MEncoder` (ResNet-50, parity) at several batches,
on the card: where a CUDA graph of the forward stops paying.

    python3 scripts/torch_graph_crossover.py [--batches 1 4 16 64] [--seconds 3] [--out F]

Each request is a closed loop's, as the benchmark's control cell makes it: uint8 NCHW
frames of 224 px from pageable host memory, the embedding copied to the host. For each
batch the two modes run in turns (eager, graphed, graphed, eager), each for `--seconds`
after three warm-up calls; graphs are forced on at every batch by raising
`graphs.MAX_BATCH` and off by setting it to 0. Prints one JSON line a batch (host ms a
request, p50 and p95; host ms until the encoder returns, p50; the memory the graph's
pool reserved) and writes them all to `--out` as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from r3m_tpu_torch.models import graphs  # noqa: E402
from r3m_tpu_torch.models.r3m import R3MConfig, R3MEncoder, r3m_init  # noqa: E402

POOL = 8  # distinct requests, cycled


def timed(enc, frames, seconds):
    for i in range(3):  # eager, then (graphed) the capture and a replay
        enc(frames[i % POOL]).cpu()
    torch.cuda.synchronize()
    request, enqueue = [], []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        t = time.perf_counter()
        out = enc(frames[len(request) % POOL])
        t_ret = time.perf_counter()
        out.cpu()
        request.append(time.perf_counter() - t)
        enqueue.append(t_ret - t)
    request, enqueue = np.array(request) * 1e3, np.array(enqueue) * 1e3
    return {"requests": len(request), "p50_ms": float(np.percentile(request, 50)),
            "p95_ms": float(np.percentile(request, 95)),
            "enqueue_p50_ms": float(np.percentile(enqueue, 50))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 4, 16, 64])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default="graph_crossover.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                            "-i", "0"], capture_output=True, text=True).stdout.strip()
    card = {"kind": torch.cuda.get_device_name(0), "power_limit": limit}
    cfg = R3MConfig(size=50)
    state = r3m_init(cfg, seed=0).convnet.state_dict()
    rng = np.random.default_rng(0)
    rows = []
    for b in args.batches:
        frames = [torch.from_numpy(rng.integers(0, 256, (b, 3, 224, 224), dtype=np.uint8))
                  for _ in range(POOL)]
        row = {"batch": b, "eager": [], "graphed": [], **card}
        for mode in ("eager", "graphed", "graphed", "eager"):
            graphs.MAX_BATCH = max(args.batches) if mode == "graphed" else 0
            enc = R3MEncoder(cfg, state)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved()
            run = timed(enc, frames, args.seconds)
            run["reserved_mb"] = (torch.cuda.memory_reserved() - reserved) / 2**20
            run["captures"], run["replays"] = enc.graph_captures, enc.graph_replays
            row[mode].append(run)
            del enc
        for key in ("p50_ms", "p95_ms", "enqueue_p50_ms"):
            e = [r[key] for r in row["eager"]]
            g = [r[key] for r in row["graphed"]]
            row[f"{key}_eager_over_graphed"] = float(np.median(e) / np.median(g))
        print(json.dumps(row), flush=True)
        rows.append(row)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
