"""The whole teacher step's share of the card's float32 peak: the forward and
backward MACs (no input gradients, the view-direction product once a ray)
of every point of both passes of the traced window's rays, over the
window."""
from perfbench import yardstick as Y


def read(v):
    c = v.config
    per_ray = (Y.nerf_samples_per_ray(c) * Y.nerf_point_train_macs(c)
               + Y.passes(c) * Y.nerf_ray_train_macs(c))
    macs = v.requests * v.counters["rays_per_request"] * per_ray
    return Y.share(2.0 * macs, v.trace.window_s, Y.PEAK_F32_FLOPS)
