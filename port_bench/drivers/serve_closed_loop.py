"""The serving window: one client in a closed loop calls ``r3m_tpu_torch``'s
``R3MEncoder`` with requests of uint8 NCHW frames from pageable host memory.

Set-up draws the backbone's weights from the seed on the device and builds the encoder
from that state dict as ``load_r3m_from_files`` builds it (no weight file is written),
makes the pool of requests on the device and moves it to host memory, and warms the
request's shape. In the window each request runs from the call until its embedding is on
the host (``to_host``) or queued on the device; the window ends on a synchronize. A
sample of the answers, drawn from the seed, is kept, and after the window the plain
reference embeds the same frames.
"""

from __future__ import annotations

import random
import sys
import time
import traceback

import numpy as np
import torch

from port_bench import compare, traffic, weights
from port_bench.reference import nets
from port_bench.reference import r3m as ref
from port_bench.reference.precision import Arith

WARMUP = 3
BLOCK = 64  # frames a reference call embeds


def seeds(seed: int) -> dict:
    return {"weights": seed, "traffic": seed + 2, "order": seed + 4, "sample": seed + 5}


def backbone_specs(cfg: dict):
    bb = cfg["backbone"]
    return nets.vit_specs(bb) if bb["kind"] == "vit" else nets.resnet_specs(bb, serving=True)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Cell:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, fault=None):
        from r3m_tpu_torch.models.r3m import R3MConfig, R3MEncoder

        self.cfg, self.mix, self.device, self.fault = cfg, mix, device, fault
        self.seeds = seeds(seed)
        self.phases, t = {}, time.perf_counter()
        model = cfg["model"]
        rcfg = R3MConfig(size=model["size"], image_size=model["image_size"], langweight=0.0)
        self.encoder = R3MEncoder(rcfg, self._weights(), precision=mix["precision"],
                                  device=device)
        self.frames = traffic.frame_pool(mix, self.seeds["traffic"], device).cpu()
        self.order = traffic.request_order(mix, self.seeds["order"])
        self.phases["encoder_and_pool"], t = time.perf_counter() - t, time.perf_counter()
        for i in range(WARMUP):
            self._request(i)
        sync(device)
        self.phases["warmup"] = time.perf_counter() - t

    def _weights(self):
        return weights.make_tensors(backbone_specs(self.cfg), self.seeds["weights"],
                                    self.device)

    def _request(self, i: int):
        out = self.encoder(self.frames[self.order[i % len(self.order)]])
        return out.cpu() if self.mix["to_host"] else out

    def window(self, seconds: float, probe, spans) -> dict:
        mix = self.mix
        sampler = random.Random(self.seeds["sample"])
        kept = []  # (request index, output): a uniform sample of the window's answers
        flags, latency, enqueue, errors = [], [], [], 0
        offset = WARMUP
        probe.start()
        sync(self.device)
        t0 = time.perf_counter()
        n = 0
        while True:
            i = offset + n
            try:
                t_call = time.perf_counter()
                out = self.encoder(self.frames[self.order[i % len(self.order)]])
                t_ret = time.perf_counter()
                if mix["to_host"]:
                    out = out.cpu()
                t_done = time.perf_counter()
                latency.append(t_done - t_call)
                enqueue.append(t_ret - t_call)
                if self.fault == "altered":
                    out = out.flip(-1)
                flags.append(torch.isfinite(out).all())
                slot = n if n < mix["sampled"] else sampler.randrange(n + 1)
                if slot < mix["sampled"]:
                    if n < mix["sampled"]:
                        kept.append((i, out))
                    else:
                        kept[slot] = (i, out)
            except Exception:  # the window goes on; the request counts as failed
                if not errors:
                    traceback.print_exc(file=sys.stderr)
                errors += 1
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        sync(self.device)
        elapsed = time.perf_counter() - t0
        probe.stop()
        spans["request"], spans["enqueue"] = latency, enqueue
        self.kept = kept
        nonfinite = sum(not bool(f) for f in flags)
        quantiles = (np.percentile(latency, (50, 90, 95, 99)) * 1e3).tolist() if latency else []
        return {"attempted": n, "failed": errors + nonfinite, "window_s": elapsed,
                "request_ms_p50_p90_p95_p99": quantiles,
                "end_to_end": {
                    "serve_frames_per_s": n * mix["frames"] / elapsed,
                    "request_p95_ms": float(np.percentile(latency, 95)) * 1e3 if latency
                    else None}}

    def release(self) -> None:
        self.encoder = None
        self.kept = [(i, out.cpu()) for i, out in self.kept]
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, arith: Arith, indices) -> torch.Tensor:
        """The reference's embeddings of the requests `indices`, a block at a time."""
        params = self._weights()
        frames = torch.cat([self.frames[self.order[i % len(self.order)]] for i in indices])
        out = [ref.serve(self.cfg, params, frames[s:s + BLOCK].to(self.device), arith).cpu()
               for s in range(0, len(frames), BLOCK)]
        return torch.cat(out)

    def check(self) -> dict:
        indices = [i for i, _ in self.kept]
        got = torch.cat([out for _, out in self.kept])
        return {"embed_gap": compare.embedding_gap(got, self.reference(Arith("f32"), indices))}
