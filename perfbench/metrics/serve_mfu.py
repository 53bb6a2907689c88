"""The whole frame's share of the card's bf16 peak: the student's forward
MACs of every ray the traced window served, over the window."""
from perfbench import yardstick as Y


def read(v):
    macs = v.requests * v.counters["rays_per_request"] * Y.r2l_forward_macs(v.config)
    return Y.share(2.0 * macs, v.trace.window_s, Y.PEAK_BF16_FLOPS)
