"""Spans and the device trace of one traced window, reduced to the numbers
the per-layer readers take.

The benchmark marks its own spans with `torch.profiler.record_function`
(`pb.window` around the traced window, `pb.request` around each request,
`pb.fetch` around a batch fetch), so that they share the profiler's clock
with the card's kernels and copies. A `Trace` holds plain lists, so that the
arithmetic is tested on the CPU with made-up events.
"""
from __future__ import annotations

import bisect
import heapq
from typing import Dict, Iterable, List, Sequence, Tuple

Interval = Tuple[str, float, float]     # (name, start us, end us)

# host calls in which the host waits for the card
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")
WINDOW_SPAN = "pb.window"
REQUEST_SPAN = "pb.request"
FETCH_SPAN = "pb.fetch"
NO_HOST_OP = "(no host op)"


def union_us(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


class Trace:
    """The device's intervals (kernels and copies) and the host's (ops,
    runtime calls and the benchmark's spans) of one traced window.

    `window` is (start, end) in us on the profiler's clock; device intervals
    are clipped to it."""

    def __init__(self, device: Sequence[Interval], host: Sequence[Interval],
                 window: Tuple[float, float]):
        t0, t1 = window
        self.window = window
        self.device = sorted(((n, max(s, t0), min(e, t1)) for n, s, e in device
                              if e > t0 and s < t1), key=lambda d: (d[1], d[2]))
        self.host = list(host)

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        """Reads a finished `torch.profiler.profile`. A range that a host op
        or `record_function` marks on the card's timeline bears that op's
        name and spans its gaps: it is left out of the device's intervals."""
        from torch.autograd import DeviceType

        events = prof.events()
        host = [(e.name, e.time_range.start, e.time_range.end) for e in events
                if e.device_type != DeviceType.CUDA]
        names = {n for n, _, _ in host}
        device = [(e.name, e.time_range.start, e.time_range.end) for e in events
                  if e.device_type == DeviceType.CUDA and e.name not in names]
        spans = [(s, e) for n, s, e in host if n == WINDOW_SPAN]
        if len(spans) != 1:
            raise RuntimeError(f"expected one {WINDOW_SPAN} span in the trace, found "
                               f"{len(spans)}")
        return cls(device, host, spans[0])

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_s(self) -> float:
        """Seconds of the window in which a kernel or a copy ran."""
        return union_us((s, e) for _, s, e in self.device) / 1e6

    def idle_share(self) -> float:
        """Per cent of the window in which the card ran nothing."""
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def kernel_s(self, names: Sequence[str]) -> float:
        """Summed seconds of the device intervals whose name holds one of
        `names` (a kernel's function name, which the trace gives with its
        return type and template arguments)."""
        return sum(e - s for n, s, e in self.device if _named(n, names)) / 1e6

    def launches(self, names: Sequence[str]) -> int:
        return sum(1 for n, _, _ in self.device if _named(n, names))

    def spans(self, name: str) -> List[Tuple[float, float]]:
        return sorted((s, e) for n, s, e in self.host if n == name)

    def span_s(self, name: str) -> float:
        return sum(e - s for s, e in self.spans(name)) / 1e6

    def host_calls_within_s(self, calls: Sequence[str], span: str) -> float:
        """Seconds of the host calls named in `calls` that start inside one of
        the `span` spans (on any thread)."""
        spans = self.spans(span)
        starts = [s for s, _ in spans]
        total = 0.0
        for n, s, e in self.host:
            if n not in calls:
                continue
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and s < spans[i][1]:
                total += e - s
        return total / 1e6

    def idle_gaps(self) -> List[Tuple[float, float]]:
        """The window's stretches in which the card ran nothing."""
        gaps, end = [], self.window[0]
        for _, s, e in self.device:
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        if self.window[1] > end:
            gaps.append((end, self.window[1]))
        return gaps

    def gaps_by_host_op(self) -> Dict[str, float]:
        """Idle seconds by the host op running at each gap's midpoint: the
        innermost (latest started) op that encloses it, on any thread."""
        gaps = sorted(((s + e) / 2, e - s) for s, e in self.idle_gaps())
        ops = sorted((s, e, n) for n, s, e in self.host
                     if n not in (WINDOW_SPAN,) and e > s)
        out: Dict[str, float] = {}
        active: list = []          # heap of (-start, end, name)
        i = 0
        for t, length in gaps:
            while i < len(ops) and ops[i][0] <= t:
                s, e, n = ops[i]
                heapq.heappush(active, (-s, e, n))
                i += 1
            while active and active[0][1] <= t:
                heapq.heappop(active)
            # ops that ended below the top stay in the heap until they reach
            # it: the midpoints only increase, so they never come back
            name = active[0][2] if active else NO_HOST_OP
            out[name] = out.get(name, 0.0) + length / 1e6
        return out

    def breakdown(self, n: int = 10) -> Dict[str, list]:
        """The device ops that took the most time and the longest idle
        stretches by what the host was doing, each as [name, seconds]."""
        by_op: Dict[str, float] = {}
        for name, s, e in self.device:
            by_op[name] = by_op.get(name, 0.0) + (e - s) / 1e6
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.gaps_by_host_op().items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[_short(k), v] for k, v in top],
                "idle_gaps": [[_short(k), v] for k, v in gaps]}


def _named(name: str, names: Sequence[str]) -> bool:
    return any(k in name for k in names)


def _short(name: str, limit: int = 160) -> str:
    return name if len(name) <= limit else name[:limit - 3] + "..."

