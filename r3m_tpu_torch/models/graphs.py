"""CUDA graphs of `R3MEncoder`'s small-batch forward.

A batch-1 ResNet-50 request is ~250 kernel launches, each a few microseconds of work:
issued eagerly, the host's dispatch sets the pace and the card idles most of the time.
Captured once as a CUDA graph, the same kernels go out in one launch.

`engages` says where a forward is graphed, `capture` captures one (the seam a test stands
in with an eager call), and `GraphCache` keeps an encoder's captured forwards by key.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Any, Callable, Tuple

import torch

# Above about 16 parity frames the device time of a request outlasts the eager dispatch
# of its launches (~4-6 ms), so a graph saves little, while its private memory pool keeps
# the activations of its shape (GBs at large batches) for as long as it lives.
MAX_BATCH = 16
MAX_KEYS = 4  # captured shapes an encoder keeps, least recently used out first
WARMUP = 3  # eager runs on a side stream before a capture, as torch's recipe has it


def engages(owns_weights: bool, device: torch.device, batch: int) -> bool:
    """Whether a forward of `batch` frames on `device` goes through a graph: only over
    serving weights the encoder owns and refreshes through its refold (a graph reads
    fixed addresses, which only the encoder knows when it replaces), on a CUDA device,
    and at most `MAX_BATCH` frames."""
    return owns_weights and device.type == "cuda" and batch <= MAX_BATCH


def capture(fn: Callable[[torch.Tensor], torch.Tensor],
            static_in: torch.Tensor) -> Tuple[Callable[[], None], torch.Tensor]:
    """``fn(static_in)`` captured as one CUDA graph with a private memory pool, after
    `WARMUP` eager runs on a side stream. Returns ``(replay, static_out)``: each
    ``replay()`` recomputes `static_out` in place from what `static_in` holds. The last
    call of `fn` is the captured one."""
    with torch.cuda.device(static_in.device):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                fn(static_in)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static_out = fn(static_in)
    return graph.replay, static_out


@dataclasses.dataclass
class Graphed:
    """One captured forward. It holds the serving weights its kernels read, so that no
    replay reads memory that was freed and reused."""

    replay: Callable[[], None]
    static_in: torch.Tensor
    static_out: torch.Tensor
    weights: Any
    k1_launches: int  # the K1 launches one replay runs


class GraphCache:
    """An encoder's captured forwards by key, at most `MAX_KEYS`, least recently used
    out first. A key's first call leaves ``None`` (that call runs eagerly, warming
    cuDNN's plans and the allocator for the capture); a key whose capture raised is in
    `failed` and stays eager. `lock` serialises the use of the static buffers."""

    def __init__(self):
        self.lock = threading.Lock()
        self.entries: "collections.OrderedDict[tuple, Graphed | None]" = (
            collections.OrderedDict())
        self.failed: set = set()

    def __reduce__(self):
        # a copy starts empty: a graph belongs to its process and to its weights
        return (GraphCache, ())

    def seen(self, key) -> bool:
        """Whether `key` had a call before this one; marks it as used, and evicts past
        `MAX_KEYS`. Call with `lock` held."""
        if key in self.entries:
            self.entries.move_to_end(key)
            return True
        self.entries[key] = None
        while len(self.entries) > MAX_KEYS:
            self.entries.popitem(last=False)
        return False

    def clear(self) -> None:
        with self.lock:
            self.entries.clear()
