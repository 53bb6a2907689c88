"""The whole distillation step's share of the card's bf16 peak: the forward
and backward MACs (no input gradient, no recomputation) of every ray of the
traced window's steps, the hard rays with them, over the window."""
from perfbench import yardstick as Y


def read(v):
    per_ray = Y.r2l_forward_macs(v.config) + Y.r2l_backward_macs(v.config)
    macs = v.requests * v.counters["rays_per_request"] * per_ray
    return Y.share(2.0 * macs, v.trace.window_s, Y.PEAK_BF16_FLOPS)
