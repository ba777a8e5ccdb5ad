"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py            # from the root of a checkout; needs one CUDA card

Phases, in order; any failure ends the run with a non-zero exit and no result line:

1. print the card's name and power limit (nvidia-smi);
2. build every kernel of ``r3m_tpu_torch/csrc`` from the checkout's sources;
3. K1 (stem max-pool) against its plain PyTorch version at the ResNet stem's shape,
   f32 and bf16, exact; times of the kernel, the plain version, ``F.max_pool2d`` and the
   bound;
4. K3 (fused attention) against its plain version at ViT-B/32 serving width, f32 and
   bf16; the same four times, with SDPA as the library yardstick;
5. ResNet-50 serving through ``load_r3m_from_files`` (seeded random weights written as a
   reference ``model.pt``), parity and fast: a few requests of 256 frames at 224 px and
   one of 240x320 frames; shapes, finiteness, fast-vs-parity cosine, agreement with the
   CPU path on a small input, and K1's launch count over the served requests;
6. ViT-B/32 serving, the same, with K3's launch count;
7. one JSON line with every kernel's numbers, then the result line.

Uses no JAX: the port is checked against its own plain versions and its CPU path.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

SEED = 0
BATCH = 256
REQUESTS = 4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # f32 without tensor cores
ATTENTION_ATOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
DT_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}


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


def check_pool(gen) -> dict:
    from r3m_tpu_torch.ops.pool import maxpool_3x3s2, maxpool_3x3s2_reference

    shape = (BATCH, 112, 112, 64)  # the ResNet stem after conv1, NHWC
    rows = {}
    for dt in (torch.float32, torch.bfloat16):
        x = torch.randn(shape, generator=gen, device="cuda").to(dt)
        y = maxpool_3x3s2(x)
        ref = maxpool_3x3s2_reference(x)
        torch.cuda.synchronize()
        if not torch.equal(y, ref):
            raise AssertionError(f"K1 {dt}: kernel differs from its plain version")
        err = (y.float() - ref.float()).abs().max().item()
        nbytes = (x.numel() + y.numel()) * x.element_size()
        bound, by = bound_ms(nbytes, 9 * y.numel(), dt)
        x_nchw = x.permute(0, 3, 1, 2)  # channels_last NCHW view of the same memory
        row = {
            "max_abs_err": err,
            "ms": time_ms(lambda: maxpool_3x3s2(x)),
            "plain_ms": time_ms(lambda: maxpool_3x3s2_reference(x)),
            "bound_ms": bound,
            "bound_by": by,
            "library_ms": time_ms(lambda: F.max_pool2d(x_nchw, 3, 2, 1)),
        }
        rows[DT_NAMES[dt]] = row
        log(f"K1 maxpool {DT_NAMES[dt]} {list(shape)}: exact; {json.dumps(row)}")
        del x, y, ref
    return rows


def check_attention(gen) -> dict:
    from r3m_tpu_torch.ops.attention import fused_attention, fused_attention_reference

    b, t, h, d = BATCH, 50, 12, 64  # ViT-B/32 at 224 px
    rows = {}
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn((b, t, h * d), generator=gen, device="cuda").to(dt)
                   for _ in range(3))
        o = fused_attention(q, k, v, h)
        ref = fused_attention_reference(q, k, v, h)
        torch.cuda.synchronize()
        err = (o.float() - ref.float()).abs().max().item()
        atol = ATTENTION_ATOL[dt]
        if not err <= atol:
            raise AssertionError(f"K3 {dt}: max abs error {err} > {atol}")
        nbytes = 4 * q.numel() * q.element_size()
        bound, by = bound_ms(nbytes, 2 * b * h * 2 * t * t * d, dt)
        qh, kh, vh = (x.view(b, t, h, d).transpose(1, 2) for x in (q, k, v))
        lib = F.scaled_dot_product_attention(qh, kh, vh).transpose(1, 2).reshape(b, t, -1)
        log(f"K3 {DT_NAMES[dt]}: max abs difference from SDPA (informative) "
            f"{(o.float() - lib.float()).abs().max().item()}")
        row = {
            "max_abs_err": err,
            "ms": time_ms(lambda: fused_attention(q, k, v, h)),
            "plain_ms": time_ms(lambda: fused_attention_reference(q, k, v, h)),
            "bound_ms": bound,
            "bound_by": by,
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh)),
        }
        rows[DT_NAMES[dt]] = row
        log(f"K3 attention {DT_NAMES[dt]} {[b, t, h * d]} H={h}: atol {atol}; "
            f"{json.dumps(row)}")
    return rows


def write_model_pt(path: str, convnet: torch.nn.Module) -> None:
    """A reference-format model.pt: ``{"r3m": {"module.convnet.<key>": tensor}}``."""
    sd = {f"module.convnet.{k}": v for k, v in convnet.state_dict().items()}
    torch.save({"r3m": sd}, path)


def cosine_rows(a: torch.Tensor, b: torch.Tensor) -> np.ndarray:
    a, b = a.double().cpu().numpy(), b.double().cpu().numpy()
    return np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def serve(name: str, convnet: torch.nn.Module, out_dim: int, counter, min_cosine: float,
          tmp: str) -> dict:
    """Serve requests through load_r3m_from_files; return the kernel's launches and
    frames/s. `min_cosine` bounds fast against parity, row by row."""
    import r3m_tpu_torch
    from r3m_tpu_torch.ops.attention import fused_attention
    from r3m_tpu_torch.ops.pool import maxpool_3x3s2

    path = os.path.join(tmp, f"{name}.pt")
    write_model_pt(path, convnet)
    rng = np.random.default_rng(SEED)
    frames = [rng.integers(0, 256, (BATCH, 3, 224, 224), dtype=np.uint8)
              for _ in range(REQUESTS)]
    odd = rng.integers(0, 256, (64, 3, 240, 320), dtype=np.uint8)

    maxpool_3x3s2.launches = 0
    fused_attention.launches = 0
    out, fps = {}, {}
    for precision in ("parity", "fast"):
        enc = r3m_tpu_torch.load_r3m_from_files(path, precision=precision)
        first = enc(frames[0])  # warms cuDNN's algorithm choice
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for f in frames:
            e = enc(f)
        torch.cuda.synchronize()
        fps[precision] = BATCH * len(frames) / (time.perf_counter() - t0)
        e_odd = enc(odd)
        for got, n in ((first, BATCH), (e, BATCH), (e_odd, len(odd))):
            if got.shape != (n, out_dim) or got.dtype != torch.float32:
                raise AssertionError(f"{name} {precision}: output {got.shape} {got.dtype}")
            if not torch.isfinite(got).all():
                raise AssertionError(f"{name} {precision}: non-finite embeddings")
        out[precision] = (first, e_odd)
        del enc
    launches = counter.launches
    if launches == 0:
        raise AssertionError(f"{name}: the serving path never launched its kernel")

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

    from r3m_tpu_torch.models.resnet import ResNet
    from r3m_tpu_torch.models.vit import ViT
    from r3m_tpu_torch.ops import _build
    from r3m_tpu_torch.ops.attention import fused_attention
    from r3m_tpu_torch.ops.pool import maxpool_3x3s2

    t0 = time.perf_counter()
    built = _build.build()
    log(f"built {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    for name, (path, compiler_log) in built.items():
        log(f"{name}: {path}\n{compiler_log.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    pool_rows = check_pool(gen)
    attn_rows = check_attention(gen)

    torch.manual_seed(SEED)
    resnet = ResNet(50)
    with torch.no_grad():  # non-trivial BN statistics, so the fold does real work
        for m in resnet.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5)
                m.bias.uniform_(-0.1, 0.1)
                m.running_mean.uniform_(-0.1, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    with tempfile.TemporaryDirectory() as tmp:
        r50 = serve("resnet50", resnet, 2048, maxpool_3x3s2, 0.9999, tmp)
        del resnet
        # ViT-B/32 in bf16 carries its residual stream in bf16 through 12 layers, as the
        # JAX package's fast path does; with these N(0, 0.02) weights both packages'
        # fast paths land at cosine ~0.9999 against parity on the CPU, so the bound is
        # looser than the ResNet's.
        vit = serve("vit_b32", ViT(), 768, fused_attention, 0.9995, tmp)

    def entry(name, source, replaces, rows, launches):
        main_row = dict(rows["f32"])
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, **main_row, "bf16": rows["bf16"]}

    kernels = [
        entry("maxpool_3x3s2", "r3m_tpu_torch/csrc/maxpool.cu",
              "r3m_tpu/ops/pallas_pool.py:109", pool_rows, r50["launches"]),
        entry("fused_attention", "r3m_tpu_torch/csrc/attention.cu",
              "r3m_tpu/ops/attention.py:221", attn_rows, vit["launches"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
