"""Kernel 3a (ops/r2l_train, r2l_train_fwd_kernel) against its roofline: the
forward MACs of the steps' rays (bf16 weights read once, each ray's points
read and its rgb written once) over its time on the card. None where the
kernel did not run."""
from perfbench import yardstick as Y

KERNELS = ("r2l_train_fwd_kernel",)


def read(v):
    t = v.trace.kernel_s(KERNELS)
    if t <= 0:
        return None
    rays = v.requests * v.counters["rays_per_request"]
    nbytes = (v.trace.launches(KERNELS) * 2 * Y.r2l_weight_count(v.config)
              + rays * (v.config["n_sample"] * 3 + 3) * 4)
    return Y.roofline_share(2.0 * rays * Y.r2l_forward_macs(v.config), nbytes, t)
