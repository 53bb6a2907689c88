"""Profiling / tracing utilities, after `efficient_nerf_tpu.utils.profiling`.

`trace` records a `torch.profiler` trace (CPU and, on a card, CUDA
activity) and writes a Chrome trace; `compiled_cost` counts the FLOPs of a
call with `torch.utils.flop_counter.FlopCounterMode` (the analytic
models/flops.py numbers are the architecture's cost; this is what the ops
that ran count).

`span(name)` marks a stretch of the program's host work. It is on exactly
while a `torch.profiler` session runs (`trace`, or any `profile`), and then
enters `torch.profiler.record_function(name)`: the span lands among the
profiler's events, on the clock of the card's kernels and copies, nested in
the spans around it on its thread (the autograd engine's threads inherit
the profiler). The profiler does not see a thread the program started
itself, such as a loader's worker: a span there is also appended, as
(name, thread, start_ns, end_ns, seq), to a bounded in-memory log that
`spans_logged()` reads and `trace()` clears. Its stamps are `time.time_ns()`,
not the profiler's clock: read durations and counts from it. `seq` ties a
batch's read to the wait that took the batch: a span given one, or given one
in its block (`s.seq = ...`), is logged on any thread. With no profiler
running, `span` costs one flag read and returns a shared no-op context.
"""
from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["trace", "compiled_cost", "span", "spans_logged", "LoggedSpan"]

LOG_ENTRIES = 65536


class LoggedSpan(NamedTuple):
    name: str
    thread: str
    start_ns: int
    end_ns: int
    seq: Optional[int]


_LOG: "collections.deque[LoggedSpan]" = collections.deque(maxlen=LOG_ENTRIES)
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "seq", "_rf", "_start", "_log")

    def __init__(self, name: str, seq: Optional[int]):
        self.name, self.seq = name, seq

    def __enter__(self) -> "_Span":
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        # the profiler's own per-thread state: off on threads it does not see
        self._log = not torch.autograd._profiler_enabled()
        self._start = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        end = time.time_ns()
        self._rf.__exit__(*exc)
        if self._log or self.seq is not None:
            _LOG.append(LoggedSpan(self.name, threading.current_thread().name,
                                   self._start, end, self.seq))


def span(name: str, seq: Optional[int] = None):
    """A context that marks `name` while a profiler runs; the shared no-op
    context otherwise, whose `as` target is None."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, seq)


def spans_logged() -> List[LoggedSpan]:
    """The log's entries, oldest first: spans of threads the profiler does
    not see, and spans that name a batch (`seq`)."""
    return list(_LOG)


@contextlib.contextmanager
def trace(logdir: str):
    """Record the enclosed block with torch.profiler; writes
    <logdir>/trace.json (chrome://tracing, Perfetto). The span log is
    cleared on entry, so that it holds this block's entries."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    _LOG.clear()
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
