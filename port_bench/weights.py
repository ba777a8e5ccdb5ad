"""Weights from the seed, on the device, in a few large calls.

`make_tensors` takes ``(name, shape, law)`` specs (`port_bench.reference.nets`) and draws
every ``normal`` tensor from one `torch.randn` and every ``uniform`` one from one
`torch.rand` of a generator seeded with the seed, in spec order: the same seed gives the
same tensors on the same device. The benchmark hands the same tensors to the system and to
the reference.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

Specs = List[tuple]


def make_tensors(specs: Specs, seed: int, device) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = {law: sum(math.prod(shape) for _, shape, (kind, *_) in specs if kind == law)
             for law in ("normal", "uniform")}
    flat = {
        "normal": torch.randn(sizes["normal"], generator=gen, device=device),
        "uniform": torch.rand(sizes["uniform"], generator=gen, device=device),
    }
    offset = {"normal": 0, "uniform": 0}
    out = {}
    for name, shape, (kind, *args) in specs:
        n = math.prod(shape)
        if kind == "count":
            out[name] = torch.zeros(shape, dtype=torch.int64, device=device)
            continue
        if kind == "const":
            out[name] = torch.full(shape, args[0], dtype=torch.float32, device=device)
            continue
        piece = flat[kind][offset[kind]:offset[kind] + n].reshape(shape)
        offset[kind] += n
        if kind == "normal":
            out[name] = piece * args[0]
        else:
            lo, hi = args
            out[name] = piece * (hi - lo) + lo
    return out
