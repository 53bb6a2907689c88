"""Host milliseconds a step waited in ShardLoader's next() (the benchmark's
pb.fetch span)."""
from perfbench import tracing


def read(v):
    if not v.trace.spans(tracing.FETCH_SPAN):
        return None
    return v.trace.span_s(tracing.FETCH_SPAN) * 1e3 / v.requests
