"""Host milliseconds a training step spent in calls that wait for the card
(stream, device and event synchronisation, synchronous copies), on any
thread, inside the benchmark's request spans."""
from perfbench import tracing


def read(v):
    s = v.trace.host_calls_within_s(tracing.SYNC_CALLS, tracing.REQUEST_SPAN)
    return s * 1e3 / v.requests
