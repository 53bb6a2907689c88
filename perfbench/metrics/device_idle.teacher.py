"""Per cent of the traced window in which the card ran no kernel and no
copy (the union of their intervals in the profiler's trace)."""


def read(v):
    return v.trace.idle_share()
