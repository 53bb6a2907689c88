"""Kernel 1 (ops/r2l_forward, csrc/r2l_forward.cu) against its roofline: the
forward MACs of the rays it served (bf16 weights read once, each ray's
origin and direction read and its rgb written once) over its time on the
card. None where the kernel did not run."""
from perfbench import yardstick as Y

KERNELS = ("r2l_forward_kernel",)


def read(v):
    t = v.trace.kernel_s(KERNELS)
    if t <= 0:
        return None
    rays = v.requests * v.counters["rays_per_request"]
    launches = v.trace.launches(KERNELS)
    nbytes = launches * 2 * Y.r2l_weight_count(v.config) + rays * (6 + 3) * 4
    return Y.roofline_share(2.0 * rays * Y.r2l_forward_macs(v.config), nbytes, t)
