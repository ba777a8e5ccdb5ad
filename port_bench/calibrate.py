"""The readings that the limits of `correct` are set from, on the card at a cell's own size.

    python3 port_bench/calibrate.py --workload <cell> --seeds 1,2,3 [--control-seeds 1,2]
                                    [--window 1]

For every seed: the system's numbers against the reference, as a run of the cell compares
them (after a window of ``--window`` seconds at the cell's load). For every control seed
also the control's: the reference in the next precision below the one the configuration
states (TF32 under f32, fp8 under bf16) put in the system's place, and for a training cell
the planted fault of half the batch left out (the mean over the rest), planted in the
reference put in the system's place, and a witness: the reference itself with bfloat16
products. One JSON line a seed, then one line with the largest
sound reading and the smallest control and fault readings of each number. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_mode(spec) -> str:
    precision = spec.mix.get("precision")
    if precision is None:
        precision = "fast" if spec.config["model"]["compute_dtype"] == "bfloat16" else "parity"
    return "fp8" if precision == "fast" else "tf32"


def worst_leaves(got: dict, want: dict, n: int = 6) -> dict:
    """The leaves with the largest gaps of gradient and of change, with both norms."""
    from port_bench import compare

    out = {}
    for key, names in (("grad", sorted(want["grad"])), ("change", compare.moved_leaves(want))):
        gaps = compare.leaf_gaps(got[key], want[key], names)
        out[key] = [[k, gaps[k], got[key][k], want[key][k]]
                    for k in sorted(gaps, key=lambda k: -gaps[k])[:n]]
    out["losses"] = [got["losses"], want["losses"]]
    return out


def readings(spec, seed: int, window: float, control: bool, device: str = "cuda",
             detail: bool = False) -> dict:
    import torch

    from port_bench import compare, harness, trace
    from port_bench.reference.precision import Arith

    driver = harness.load_module("drivers", spec.mix["driver"])
    cell = driver.Cell(spec.config, spec.mix, seed, device)
    cell.window(window, trace.Probe(None), {})
    cell.release()
    out = {"seed": seed}
    if spec.mix["driver"] == "train_step":
        want = cell.reference(Arith("f32"))
        out["sound"] = compare.train_gaps(cell.readings, want)
        if detail:
            out["worst"] = worst_leaves(cell.readings, want)
        if control:
            mode = control_mode(spec)
            out["control"] = compare.train_gaps(cell.reference(Arith(mode)), want)
            out["fault_half"] = compare.train_gaps(cell.reference(Arith("f32"),
                                                                  drop_half=True), want)
            out["witness_bf16"] = compare.train_gaps(cell.reference(Arith("bf16")), want)
    else:
        indices = [i for i, _ in cell.kept]
        got = torch.cat([o for _, o in cell.kept])
        want = cell.reference(Arith("f32"), indices)
        out["sound"] = {"embed_gap": compare.embedding_gap(got, want)}
        if control:
            ctrl = cell.reference(Arith(control_mode(spec)), indices)
            out["control"] = {"embed_gap": compare.embedding_gap(ctrl, want)}
    del cell
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def summary(lines) -> dict:
    out = {}
    for kind, pick in (("sound", max), ("control", min), ("fault_half", min)):
        rows = [line[kind] for line in lines if kind in line]
        if rows:
            out[kind] = {k: pick(r[k] for r in rows) for k in rows[0]}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--window", type=float, default=1.0)
    ap.add_argument("--compute-dtype", default=None,
                    help="run a training cell's system in this dtype (a witness run)")
    ap.add_argument("--detail", action="store_true", help="print the worst leaves")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from port_bench import harness

    spec = harness.find_cell(args.workload, ROOT)
    if args.compute_dtype:
        spec.config["model"]["compute_dtype"] = args.compute_dtype
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    lines = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        lines.append(readings(spec, seed, args.window, seed in controls,
                              detail=args.detail))
        print(json.dumps(lines[-1]), flush=True)
    print(json.dumps({"workload": args.workload, "summary": summary(lines)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
