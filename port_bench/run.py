"""Run one cell of the benchmark of ``r3m_tpu_torch`` on the card and print its result.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each number compared with the reference beside its limit, which are also
the last lines of standard error. Exits with another code than 0, and prints no result,
where the card or the system is missing or the run loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".port_bench_cache")


def power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    # Kernel caches live in the checkout, at fixed paths; no library pulls in JAX.
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(CACHE, "torch_extensions"))
    os.environ["USE_FLAX"] = os.environ["USE_JAX"] = os.environ["USE_TF"] = "0"
    sys.path.insert(0, ROOT)

    from port_bench import harness

    spec = harness.find_cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        print(f"{args.workload} needs {spec.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import r3m_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the system under test, r3m_tpu_torch, is not in this checkout: {e}",
              file=sys.stderr)
        return 2

    result, checks = harness.run_cell(spec, args.seed, args.seconds, bool(args.trace),
                                      "cuda", T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}, which the benchmark may not load",
              file=sys.stderr)
        return 3
    result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                        "count": spec.chips, **result["device"],
                        "power_limit_w": power_limit_w()}
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    for name, c in checks.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
