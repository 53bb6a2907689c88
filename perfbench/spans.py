"""The program's own spans (`efficient_nerf_tpu_torch.utils.profiling.span`)
reduced to the numbers the per-layer readers take. Each returns None where
the trace or the log holds no such span, as a program without it gives."""
from __future__ import annotations

from typing import Optional

from . import tracing


def ms_per_request(v, name: str) -> Optional[float]:
    """Milliseconds a request in the spans `name`."""
    if not v.trace.spans(name):
        return None
    return v.trace.span_s(name) * 1e3 / v.requests


def sync_ms_per_request(v, name: str) -> Optional[float]:
    """Milliseconds a request in the host calls that wait for the card
    (tracing.SYNC_CALLS, any thread) that start inside the spans `name`."""
    if not v.trace.spans(name):
        return None
    return v.trace.host_calls_within_s(tracing.SYNC_CALLS, name) * 1e3 / v.requests


def host_ms_per_request(v, name: str) -> Optional[float]:
    """Milliseconds a request in the spans `name`, less the waits for the
    card that start inside them: the host's own time."""
    total, waits = ms_per_request(v, name), sync_ms_per_request(v, name)
    return None if total is None else total - waits


def logged_mean_ms(name: str) -> Optional[float]:
    """Mean milliseconds of the span log's entries `name` (the spans of
    threads the profiler does not see), read after the traced window."""
    try:
        from efficient_nerf_tpu_torch.utils.profiling import spans_logged
    except ImportError:
        return None
    ms = [(x.end_ns - x.start_ns) / 1e6 for x in spans_logged() if x.name == name]
    return sum(ms) / len(ms) if ms else None
