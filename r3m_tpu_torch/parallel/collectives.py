"""The collectives of the data-parallel step, with their gradients.

Under the JAX package's mesh the step is one global-batch program and GSPMD inserts the
collectives; here each rank runs its rows and the step calls these. Every rank computes
the same global loss from the gathered embeddings, so `all_gather_rows`' backward sums
the W identical upstream gradients: a rank's encoder gradient arrives W times its rows'
share of the true one, and `average_gradients` divides the sum over ranks by W. A
parameter that sees only gathered tensors (the language head) has the full gradient on
every rank already, which averaging leaves as it is.

The functions run on NCCL and gloo alike (gloo stages CUDA tensors through the host).
Each counts its calls and the bytes of its result per kind in `TALLY`, which
``chip_smoke.py`` reads: the counterpart of ``collective_cost_report``
(``r3m_tpu/parallel/mesh.py:99``), which reads the compiled program's HLO.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Union

import torch
import torch.distributed as dist
from torch import nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

TALLY: Dict[str, Dict[str, int]] = {}


def reset_tally() -> None:
    TALLY.clear()


def read_tally() -> Dict[str, Dict[str, int]]:
    """``{kind: {"calls": n, "bytes": b}}`` since the last `reset_tally`."""
    return {k: dict(v) for k, v in TALLY.items()}


def _count(kind: str, t: torch.Tensor) -> None:
    entry = TALLY.setdefault(kind, {"calls": 0, "bytes": 0})
    entry["calls"] += 1
    entry["bytes"] += t.numel() * t.element_size()


def _on_comm_device(t: torch.Tensor, group) -> torch.Tensor:
    """`t` where the backend can read it: NCCL takes CUDA tensors only."""
    if t.device.type == "cpu" and dist.get_backend(group) == "nccl":
        return t.to(torch.device("cuda", torch.cuda.current_device()))
    return t


def _all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(t, group=group)
    _count("all_reduce", t)
    return t


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        out = torch.cat(parts)
        _count("all_gather", out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = _all_reduce_(grad.clone(memory_format=torch.contiguous_format), ctx.group)
        n = grad.shape[0] // dist.get_world_size(ctx.group)
        r = dist.get_rank(ctx.group)
        return grad[r * n:(r + 1) * n], None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce_(x.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_(grad.clone(memory_format=torch.contiguous_format), ctx.group), None


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's `x` concatenated on dim 0 in rank order (every rank's shape must be
    the same). Backward: the upstream gradient summed over ranks, then this rank's rows."""
    return _AllGatherRows.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of every rank's `x`. Backward: the upstream gradient summed over ranks."""
    return _AllReduceSum.apply(x, group)


def average_gradients(params: Iterable[torch.Tensor], group=None) -> None:
    """Replace each parameter's gradient by its mean over the ranks, after backward: one
    flat bucket a dtype and device, all-reduced, divided by the world size."""
    world = dist.get_world_size(group)
    buckets: Dict[tuple, List[torch.Tensor]] = {}
    for p in params:
        if p.grad is not None:
            buckets.setdefault((p.grad.dtype, p.grad.device), []).append(p.grad)
    for grads in buckets.values():
        flat = _on_comm_device(_flatten_dense_tensors(grads), group)
        _all_reduce_(flat, group).div_(world)
        for g, mean in zip(grads, _unflatten_dense_tensors(flat, grads)):
            g.copy_(mean)


def broadcast_state(items: Union[nn.Module, Iterable[torch.Tensor]], src: int = 0,
                    group=None) -> None:
    """Overwrite, in place, a module's parameters and buffers (or each given tensor) with
    rank `src`'s."""
    tensors = list(items.state_dict().values()) if isinstance(items, nn.Module) else items
    with torch.no_grad():
        for t in tensors:
            buf = _on_comm_device(t, group)
            if not buf.is_contiguous():
                buf = buf.contiguous()
            dist.broadcast(buf, src, group=group)
            _count("broadcast", buf)
            if buf is not t:
                t.copy_(buf)


def any_rank(flag: bool, device, group=None) -> bool:
    """True on every rank when `flag` is true on any (one all-reduce of a 0/1 tensor on
    `device`)."""
    t = _on_comm_device(torch.tensor([float(flag)], device=device), group)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    _count("all_reduce", t)
    return bool(t.item())


def assert_same_everywhere(t: torch.Tensor, what: str, group=None) -> None:
    """Raise on every rank whose `t` differs from rank 0's (one broadcast)."""
    mine = _on_comm_device(t, group).contiguous()
    ref = mine.clone()
    dist.broadcast(ref, 0, group=group)
    _count("broadcast", ref)
    if not torch.equal(ref, mine):
        raise RuntimeError(f"{what} differs from rank 0's on rank {dist.get_rank(group)}")
