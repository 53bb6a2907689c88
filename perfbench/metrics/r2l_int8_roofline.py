"""Kernel 4 (ops/r2l_int8, csrc/r2l_int8.cu) against its roofline: the least
time of the rays it served (the body's int8 operations at the int8 peak
plus head and tail's at the bf16 peak, or the operands read once a launch
and each ray's origin and direction read and its rgb written once at the
HBM rate, whichever is longer) over its time on the card. None where the
kernel did not run."""
from perfbench import yardstick as Y

KERNELS = ("r2l_int8_kernel",)


def read(v):
    t = v.trace.kernel_s(KERNELS)
    if t <= 0:
        return None
    rays = v.requests * v.counters["rays_per_request"]
    launches = v.trace.launches(KERNELS)
    nbytes = launches * Y.r2l_int8_weight_bytes(v.config) + rays * (6 + 3) * 4
    return Y.least_time_share(Y.r2l_int8_least_s(v.config, rays), nbytes, t)
