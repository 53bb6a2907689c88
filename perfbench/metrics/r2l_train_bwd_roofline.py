"""Kernel 3b (ops/r2l_train: pass 1 r2l_train_bwd_kernel, pass 2
r2l_wgrad_tma_kernel and r2l_wgrad_reduce_kernel) against the backward's own
roofline: its MACs without the input gradient and without recomputing the
forward (bf16 weights read and f32 gradients written once, each ray's
points and output gradient read once) over the passes' time on the card.
None where they did not run."""
from perfbench import yardstick as Y

KERNELS = ("r2l_train_bwd_kernel", "r2l_wgrad_tma_kernel", "r2l_wgrad_reduce_kernel")


def read(v):
    t = v.trace.kernel_s(KERNELS)
    if t <= 0:
        return None
    rays = v.requests * v.counters["rays_per_request"]
    nbytes = (v.requests * (2 + 4) * Y.r2l_weight_count(v.config)
              + rays * (v.config["n_sample"] * 3 + 3) * 4)
    return Y.roofline_share(2.0 * rays * Y.r2l_backward_macs(v.config), nbytes, t)
