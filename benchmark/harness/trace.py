"""The profiler's trace of the traced window, reduced to what the per-layer
readers take: every device operation with its stream, its time on the
device and the host time it was launched at, and the host ranges
(`record_function` spans of the program and of the benchmark).

A device operation's launch time is the start of the host op that launched
it. One launched outside any host op (a kernel library called through
ctypes, outside an autograd Function) takes the launch time of the
operation before it on its stream: one stream runs its work in launch
order.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from torch.autograd import DeviceType

COPIES = ("Memcpy", "Memset", "memcpy", "memset")
WINDOW = "bench.window"   # the benchmark's range around the traced window, on the main thread


@dataclass
class DeviceOp:
    name: str
    stream: int
    start: float      # s, on the trace's clock
    end: float
    launch: Optional[float]


@dataclass
class Trace:
    ops: List[DeviceOp]
    ranges: Dict[str, List[Tuple[float, float]]]
    host: List[Tuple[float, float, str, int]]         # (start, end, name, thread) of host ops
    window_s: float
    steps: int
    main_thread: int = 0

    @property
    def kernels(self) -> List[DeviceOp]:
        """The kernels (device operations other than copies and memsets)."""
        return [o for o in self.ops if not o.name.startswith(COPIES)]

    def busy_s(self) -> float:
        """Length of the union of the device operations' intervals."""
        return union_length((o.start, o.end) for o in self.ops)

    def launched_in(self, names: Iterable[str]) -> List[DeviceOp]:
        """The device operations launched while a host range of one of `names` was open."""
        spans = sorted(s for n in names for s in self.ranges.get(n, []))
        starts = [s for s, _ in spans]
        out = []
        for o in self.ops:
            if o.launch is None:
                continue
            i = bisect.bisect_right(starts, o.launch) - 1
            if i >= 0 and spans[i][0] <= o.launch < spans[i][1]:
                out.append(o)
        return out

    def device_s(self, ops: Iterable[DeviceOp]) -> float:
        return sum(o.end - o.start for o in ops)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time (by name), and the
        longest idle gaps named by the innermost host op open on the main
        thread at the gap's middle."""
        by_name: Dict[str, float] = defaultdict(float)
        for o in self.ops:
            by_name[o.name] += o.end - o.start
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        ivs = sorted((o.start, o.end) for o in self.ops)
        gaps, cur = [], None
        for s, e in ivs:
            if cur is not None and s > cur:
                gaps.append((s - cur, cur, s))
            cur = e if cur is None else max(cur, e)
        gaps.sort(reverse=True)
        named = []
        main = [h for h in self.host if h[3] == self.main_thread]
        for length, s, e in gaps[:top]:
            mid = 0.5 * (s + e)
            open_ = [h for h in main if h[0] <= mid < h[1]]
            label = max(open_, key=lambda h: h[0])[2] if open_ else "(no host op)"
            named.append([label, length])
        return {"device_ops": [[n, t] for n, t in ops], "idle_gaps": named}


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def reduce(events, window_s: float, steps: int, range_names: Sequence[str]) -> Trace:
    """A `Trace` from the profiler's events (`profile.profiler.kineto_results.events()`).

    A device operation's `linked_correlation_id` names the host op that
    launched it; that op's start is taken as the launch time."""
    ops_start: Dict[int, float] = {}
    device, ranges, host = [], defaultdict(list), []
    main = 0
    for e in events:
        if e.device_type() != DeviceType.CPU:
            if not getattr(e, "is_user_annotation", lambda: False)():
                device.append(e)
            continue
        if e.linked_correlation_id() != 0 or e.is_async():
            continue           # a runtime call (linked to its op) or an async span
        s, t = e.start_ns() * 1e-9, e.end_ns() * 1e-9
        ops_start[e.correlation_id()] = s
        host.append((s, t, e.name(), e.start_thread_id()))
        if e.name() == WINDOW:
            main = e.start_thread_id()
        if e.name() in range_names:
            ranges[e.name()].append((s, t))
    annotations = set(ranges) | {WINDOW}
    ops = [DeviceOp(e.name(), e.device_resource_id(), e.start_ns() * 1e-9, e.end_ns() * 1e-9,
                    ops_start.get(e.linked_correlation_id()))
           for e in device if e.name() not in annotations]
    ops.sort(key=lambda o: (o.stream, o.start))
    last: Dict[int, Optional[float]] = {}
    for o in ops:                     # an unlinked launch follows the one before it on its stream
        if o.launch is None:
            o.launch = last.get(o.stream)
        else:
            last[o.stream] = o.launch
    ops.sort(key=lambda o: o.start)
    return Trace(ops, dict(ranges), host, window_s, steps, main)
