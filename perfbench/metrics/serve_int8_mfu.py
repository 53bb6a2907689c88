"""The whole int8 frame's share of the card's peaks: the least time of every
ray the traced window served through the W8A8 student (body at the int8
peak, head and tail at the bf16 peak), over the window."""
from perfbench import yardstick as Y


def read(v):
    rays = v.requests * v.counters["rays_per_request"]
    return 100.0 * Y.r2l_int8_least_s(v.config, rays) / v.trace.window_s
