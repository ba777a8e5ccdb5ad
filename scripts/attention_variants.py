"""Time variants of ``r3m_tpu_torch/csrc/attention.cu`` against each other on one card.

    python3 scripts/attention_variants.py [--dtype float32] PARENT.cu VARIANT.cu [...]

Each file is built with the port's flags (in parallel, into the git-ignored build
directory), and K3 at ViT-B/32's 384 px serving and training shapes ([64, 145, 768]
and [80, 145, 768], H = 12) and K4 at the training shape run through each in turns, in
bf16 (the default) or f32: the files in order, then in reverse, 50 launches a timing. It
prints the card's name and power limit, what ``-Xptxas -v`` says of that dtype's
one-block-a-head kernels, each file's times, whether its outputs equal the first file's
bit for bit, the largest difference from them, and K3's and K4's errors against their
plain versions. A variant is a copy of the source with one change, made by hand; the parent is
usually ``git show <commit>:r3m_tpu_torch/csrc/attention.cu``. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from r3m_tpu_torch.ops import _build  # noqa: E402
from r3m_tpu_torch.ops.attention import (  # noqa: E402
    bind,
    fused_attention_bwd,
    fused_attention_bwd_reference,
    fused_attention_fwd,
    fused_attention_reference,
)

HEADS, T = 12, 145
ITERS = 50


def build(sources):
    jobs = {}
    for i, src in enumerate(sources):
        out = _build._hashed_path(f"attention_variant{i}", src, _build.NVCC_FLAGS)
        jobs[f"v{i}"] = (out, lambda tmp, src=src: [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                                                     tmp, src])
    built = _build._compile(jobs)
    return [built[f"v{i}"] for i in range(len(sources))]


def in_turns(sources, libs, launch):
    """Every library's output of `launch()`, and its times: in order, then reversed."""
    outs, ms = [], [[] for _ in libs]
    for lib in libs:
        with chip_smoke.attention_library(lib):
            outs.append(launch())
    torch.cuda.synchronize()
    order = list(range(len(libs)))
    for i in order + order[::-1]:
        with chip_smoke.attention_library(libs[i]):
            ms[i].append(chip_smoke.time_ms(launch, iters=ITERS))
    return outs, ms


def pairs(a, b):
    return zip(*((x if isinstance(x, tuple) else (x,)) for x in (a, b)))


def same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in pairs(a, b))


def diff(a, b) -> float:
    return max((x.float() - y.float()).abs().max().item() for x, y in pairs(a, b))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    parser.add_argument("sources", nargs="+")
    args = parser.parse_args()
    sources = [os.path.abspath(s) for s in args.sources]
    if len(sources) < 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    dtype = getattr(torch, args.dtype)
    print(chip_smoke.card(), flush=True)
    libs = []
    for src, (path, log) in zip(sources, build(sources)):
        libs.append(bind(ctypes.CDLL(path)))
        report = chip_smoke.ptxas_report(log, (f"{chip_smoke.DT_NAMES[dtype]}_head_kernel",))
        print(src, *(line for line in report if "Used" in line or "spill" in line),
              sep="\n  ", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b in (64, 80):
        q, k, v, do = (torch.randn((b, T, HEADS * 64), generator=gen, device="cuda").to(dtype)
                       for _ in range(4))
        ref = fused_attention_reference(q, k, v, HEADS)
        outs, ms = in_turns(sources, libs, lambda: fused_attention_fwd(q, k, v, HEADS))
        for src, o, t in zip(sources, outs, ms):
            print(f"K3 [{b},{T},{HEADS * 64}] {os.path.basename(src)} ms {t} bit_equal_to_first "
                  f"{same(o, outs[0])} max_abs_diff_from_first {diff(o, outs[0])} "
                  f"max_abs_err {diff(o, ref)}", flush=True)
        if b == 80:
            ref = fused_attention_bwd_reference(q, k, v, do, HEADS)
            outs, ms = in_turns(sources, libs, lambda: fused_attention_bwd(q, k, v, do, HEADS))
            for src, o, t in zip(sources, outs, ms):
                print(f"K4 [{b},{T},{HEADS * 64}] {os.path.basename(src)} ms {t} "
                      f"bit_equal_to_first {same(o, outs[0])} max_abs_diff_from_first "
                      f"{diff(o, outs[0])} max_abs_err {diff(o, ref)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
