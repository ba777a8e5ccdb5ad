"""The numbers that decide `correct`: readings of the system and of the reference, and
the gaps between them.

Training: each of the first three steps' loss, the norm of every leaf's first gradient,
and the norm of every leaf's change over the three steps (BatchNorm's running statistics
among the leaves). A gap of norms is taken leaf by leaf, ``|a - b|`` over the reference's
norm of that leaf or the median leaf's, whichever is larger, and the worst leaf counts.
Leaves whose reference gradient is under a thousandth of the median leaf's (a key's bias
under softmax) move by round-off alone and are left out of the change.

Serving: for every sampled answer, the L2 distance between the system's and the
reference's embedding of a frame over the reference's norm; the worst frame counts.
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import torch

NOUGHT = 1e-3  # a leaf's gradient under this share of the median leaf's is round-off
BN_MOMENTUM = 0.1


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    norms = torch._foreach_norm([tensors[k].detach().float() for k in names])
    return dict(zip(names, torch.stack(norms).tolist()))


def leaf_gaps(got: Dict[str, float], want: Dict[str, float], names: List[str]
              ) -> Dict[str, float]:
    """Each leaf's gap of norms, over its reference norm or the median leaf's."""
    floor = statistics.median(want[k] for k in names)
    return {k: abs(got[k] - want[k]) / max(want[k], floor) for k in names}


def moved_leaves(want: dict) -> List[str]:
    """The leaves whose change counts: all but those of a round-off gradient."""
    floor = statistics.median(want["grad"].values())
    return [k for k in sorted(want["change"])
            if k not in want["grad"] or want["grad"][k] >= NOUGHT * floor]


def train_gaps(got: dict, want: dict) -> Dict[str, float]:
    """`got` and `want`: ``{"losses": [...], "grad": {leaf: norm}, "change": {leaf:
    norm}, "stats": {BatchNorm buffer: tensor after the first step}}``; `want` is the
    reference's, whose gradient decides which leaves count. Besides the worst leaf's
    gradient gap, the median leaf's, and the median BatchNorm layer's first-batch variance
    gap (`var_gap1`)."""
    losses = [abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"])]
    grad = leaf_gaps(got["grad"], want["grad"], sorted(want["grad"]))
    change = leaf_gaps(got["change"], want["change"], moved_leaves(want))
    out = {"loss_gap": max(losses), "grad_gap": max(grad.values()),
           "grad_gap_median": statistics.median(grad.values()),
           "change_gap": max(change.values())}
    variances = sorted(k for k in want.get("stats", {}) if k.endswith("running_var"))
    if variances:
        # the first batch's variances, from the running variance that one update moved
        # from 1 by momentum 0.1: well away from 0, unlike the means or the changes
        out["var_gap1"] = statistics.median(
            float(torch.linalg.vector_norm(_batch_var(got["stats"][k])
                                           - _batch_var(want["stats"][k]))
                  / torch.linalg.vector_norm(_batch_var(want["stats"][k])))
            for k in variances)
    return out


def _batch_var(running_var: torch.Tensor) -> torch.Tensor:
    return (running_var - (1 - BN_MOMENTUM)) / BN_MOMENTUM


def embedding_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The worst frame's ``|got - want| / |want|`` over ``[N, D]`` embeddings."""
    got, want = got.double(), want.double()
    return (torch.linalg.vector_norm(got - want, dim=-1)
            / torch.linalg.vector_norm(want, dim=-1)).max().item()
