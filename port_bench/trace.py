"""The reduction of one traced window to what the per-layer readers read.

`Probe` runs ``torch.profiler`` over a measured window and keeps the events in memory:
the card's activity alone (``"device"``), which costs the host little, or with every host
op too (``"ops"``), which costs the host several microseconds an op. `reduce` turns its
raw events into `Window`: every device event (kernel, copy, set) with its span and the
chain of host ops that launched it (innermost first, each op's parents by nesting on its
thread), the host ops themselves for labelling idle gaps, and the union of the device's
busy intervals.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import torch

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


@dataclasses.dataclass
class DeviceEvent:
    name: str
    kind: str  # one of DEVICE_ACTIVITIES
    start_ns: int
    end_ns: int
    ops: Tuple[str, ...]  # the launching host op, then its parents

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


@dataclasses.dataclass
class Window:
    """One traced window: its host-clock length, its device events, the busy union and
    host ops by thread (sorted ``(start, end, name)``)."""

    window_s: float
    events: List[DeviceEvent]
    busy_s: float
    intervals: List[Tuple[int, int]]
    host_ops: Dict[int, List[Tuple[int, int, str]]]


class Probe:
    """Profiles between `start` and `stop` in `mode` (``"device"`` or ``"ops"``); with
    no mode it does nothing."""

    def __init__(self, mode: Optional[str] = None):
        self.mode = mode
        self.prof: Optional[torch.profiler.profile] = None

    def start(self) -> None:
        if self.mode is None:
            return
        activities = []
        if self.mode == "ops" or not torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CPU)
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=activities)
        self.prof.start()

    def stop(self) -> None:
        if self.prof is not None:
            self.prof.stop()


def _union(spans: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _activity(ev) -> str:
    """The event's kind: `DEVICE_ACTIVITIES`, ``"cpu_op"``, or something else. Older
    torch releases have no ``activity_type``: there the device and the name tell."""
    if hasattr(ev, "activity_type"):
        return str(ev.activity_type())
    name = ev.name()
    annotation = getattr(ev, "is_user_annotation", None)
    if annotation is not None and annotation():
        return "user_annotation"
    if ev.device_type() == torch.autograd.DeviceType.CUDA:
        if name == "Activity Buffer Request":
            return "other"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        return "gpu_memset" if name.startswith("Memset") else "kernel"
    return "cuda_runtime" if name.startswith("cu") else "cpu_op"


def _span_ns(ev) -> Tuple[int, int]:
    if hasattr(ev, "start_ns"):
        return ev.start_ns(), ev.start_ns() + ev.duration_ns()
    return ev.start_us() * 1000, (ev.start_us() + ev.duration_us()) * 1000


def reduce(prof: torch.profiler.profile, window_s: float) -> Window:
    raw = prof.profiler.kineto_results.events()
    ops = {}  # correlation id -> (name, start, end, thread)
    device = []
    for ev in raw:
        act = _activity(ev)
        if act in DEVICE_ACTIVITIES:
            device.append((ev.name(), act, *_span_ns(ev), ev.linked_correlation_id()))
        elif act in ("cpu_op", "user_annotation"):
            ops[ev.correlation_id()] = (ev.name(), *_span_ns(ev), ev.start_thread_id())
    # parents by nesting, thread by thread
    parent: Dict[int, Optional[int]] = {}
    host_ops: Dict[int, List[Tuple[int, int, str]]] = defaultdict(list)
    by_thread: Dict[int, List[Tuple[int, int, int]]] = defaultdict(list)
    for cid, (name, s, e, th) in ops.items():
        by_thread[th].append((s, -e, cid))
        host_ops[th].append((s, e, name))
    for items in by_thread.values():
        items.sort()
        stack: List[Tuple[int, int]] = []  # (end, cid)
        for s, neg_e, cid in items:
            while stack and stack[-1][0] <= s:
                stack.pop()
            parent[cid] = stack[-1][1] if stack else None
            stack.append((-neg_e, cid))
    for items in host_ops.values():
        items.sort()
    events = []
    for name, act, s, e, link in device:
        chain = []
        cid = link if link in ops else None
        while cid is not None and len(chain) < 64:
            chain.append(ops[cid][0])
            cid = parent.get(cid)
        events.append(DeviceEvent(name, act, s, e, tuple(chain)))
    intervals = _union([(ev.start_ns, ev.end_ns) for ev in events])
    busy = sum(e - s for s, e in intervals) / 1e9
    return Window(window_s, events, busy, intervals, dict(host_ops))


def _host_label(win: Window, t: int) -> str:
    """The innermost host op running at time `t` on the busiest thread that has one."""
    for th in sorted(win.host_ops, key=lambda k: -len(win.host_ops[k])):
        items = win.host_ops[th]
        i = bisect.bisect_right(items, (t, float("inf"), "")) - 1
        best = None
        for j in range(i, max(-1, i - 256), -1):
            s, e, name = items[j]
            if s <= t < e and (best is None or s >= best[0]):
                best = (s, name)
        if best is not None:
            return best[1]
    return "no host op"


def breakdown(win: Window, ops: Window) -> dict:
    """The device ops that took most time in `win`, and the idle gaps of `ops` (a window
    with host ops) summed by what the host was doing in the middle of each, ``[[name,
    seconds], ...]`` heaviest first."""
    by_name: Dict[str, float] = defaultdict(float)
    for ev in win.events:
        by_name[ev.name[:160]] += ev.seconds
    gaps: Dict[str, float] = defaultdict(float)
    for (_, e0), (s1, _) in zip(ops.intervals, ops.intervals[1:]):
        gaps[_host_label(ops, (e0 + s1) // 2)] += (s1 - e0) / 1e9

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {"device_ops": top(by_name), "idle_gaps": top(gaps)}


def device_seconds(win: Window, names: Sequence[str] = (), ops: Sequence[str] = (),
                   kinds: Sequence[str] = ("kernel",)) -> float:
    """Seconds of the device events of `kinds` whose name contains one of `names` or
    whose chain of launching ops has one containing one of `ops` (lower case)."""
    total = 0.0
    for ev in win.events:
        if ev.kind not in kinds:
            continue
        if any(n in ev.name for n in names) or any(
                o in op.lower() for op in ev.ops for o in ops):
            total += ev.seconds
    return total
