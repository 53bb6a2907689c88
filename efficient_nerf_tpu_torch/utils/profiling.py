"""Profiling / tracing utilities, after `efficient_nerf_tpu.utils.profiling`.

`trace` records a `torch.profiler` trace (CPU and, on a card, CUDA
activity) and writes a Chrome trace; `compiled_cost` counts the FLOPs of a
call with `torch.utils.flop_counter.FlopCounterMode` (the analytic
models/flops.py numbers are the architecture's cost; this is what the ops
that ran count); `time_fn` times a call with CUDA events on a card and
`perf_counter` on the CPU; `DeviceTimer` accumulates section times, waiting
for the card at each section's end.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Optional

import torch

__all__ = ["trace", "compiled_cost", "time_fn", "DeviceTimer"]


@contextlib.contextmanager
def trace(logdir: str):
    """Record the enclosed block with torch.profiler; writes
    <logdir>/trace.json (chrome://tracing, Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def compiled_cost(fn: Callable, *args, **kwargs) -> Dict[str, float]:
    """{"flops": the FLOPs of the ops fn(*args) ran}, counted by
    FlopCounterMode (a multiply-add counts 2)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return {"flops": float(counter.get_total_flops())}


def _on_card(device: Optional[torch.device]) -> bool:
    return device is not None and torch.device(device).type == "cuda"


def time_fn(fn: Callable, *args, reps: int = 5, warmup: int = 2,
            device: Optional[torch.device] = None, **kwargs) -> float:
    """Median seconds per fn(*args) call: CUDA events around each call on a
    card (`device`), the host's perf_counter on the CPU."""
    for _ in range(warmup):
        fn(*args, **kwargs)
    ts = []
    for _ in range(reps):
        if _on_card(device):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args, **kwargs)
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args, **kwargs)
            ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


class DeviceTimer:
    """Accumulating section timer that waits for the card at each section's
    end (host clock).

    with timer.section("forward"): ...
    timer.summary() -> {"forward": (total_s, calls)}
    """

    def __init__(self, device: Optional[torch.device] = None):
        self.device = device
        self._acc: Dict[str, list] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if _on_card(self.device):
                torch.cuda.synchronize(self.device)
            self._acc.setdefault(name, []).append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, tuple]:
        return {k: (sum(v), len(v)) for k, v in self._acc.items()}
