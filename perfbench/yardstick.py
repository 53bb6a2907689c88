"""The yardstick: the card's peaks and the least arithmetic each model needs.

Operation counts are multiply-adds (MAC) of the model's own definition, with
no recomputation and nothing a particular kernel adds, so that they read the
same work whatever implements it. A MAC counts as 2 operations. Peaks are the
published dense rates of one NVIDIA H100 SXM at its full 700 W; every share
is reported with the card's power limit beside it.
"""
from __future__ import annotations

from typing import Dict, Tuple

PEAK_BF16_FLOPS = 989e12   # dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12     # float32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12   # HBM3 bandwidth
PEAK_INT8_OPS = 1979e12    # dense int8 tensor-core rate


def r2l_forward_macs(cfg: Dict) -> int:
    """One ray through the R2L student: head, n_block x n_learnable body
    linears, tail (5,894,912 at W256 D88 with a 1008-d input)."""
    w = cfg["width"]
    return (cfg["input_dim"] * w + cfg["n_block"] * cfg["n_learnable"] * w * w
            + w * cfg["output_dim"])


def r2l_int8_macs(cfg: Dict) -> Tuple[int, int]:
    """One ray through the W8A8 student: (int8 MACs of the body, bf16 MACs
    of head and tail): 5,636,096 and 258,816 at W256 D88, which sum to
    `r2l_forward_macs`."""
    body = cfg["n_block"] * cfg["n_learnable"] * cfg["width"] ** 2
    return body, r2l_forward_macs(cfg) - body


def r2l_int8_weight_bytes(cfg: Dict) -> int:
    """Bytes of the W8A8 student's operands that a launch reads once: the
    int8 body with its f32 row scales, static activation scales and biases,
    the bf16 head and tail with their f32 biases."""
    w, body_linears = cfg["width"], cfg["n_block"] * cfg["n_learnable"]
    body, head_tail = r2l_int8_macs(cfg)
    return body + 4 * body_linears * (w + 1 + w) + 2 * head_tail + 4 * (w + cfg["output_dim"])


def r2l_int8_least_s(cfg: Dict, rays: int) -> float:
    """The least seconds the card takes for `rays` rays of the W8A8 student:
    the body's operations at the int8 peak plus head and tail's at the bf16
    peak."""
    body, head_tail = r2l_int8_macs(cfg)
    return 2.0 * rays * (body / PEAK_INT8_OPS + head_tail / PEAK_BF16_FLOPS)


def r2l_backward_macs(cfg: Dict) -> int:
    """One ray's backward without the input gradient: every layer's weight
    gradient and every activation gradient but the head's input
    (11,531,776 at W256 D88)."""
    return 2 * r2l_forward_macs(cfg) - cfg["input_dim"] * cfg["width"]


def nerf_point_macs(cfg: Dict) -> int:
    """One point through the teacher, with the view-direction product left
    out (it is once a ray, `nerf_ray_macs`): 589,952 at D8 W256."""
    w, c = cfg["width"], cfg["input_ch"]
    macs = c * w
    for i in range(1, cfg["depth"]):
        macs += (w + c if (i - 1) in cfg["skips"] else w) * w
    if cfg["use_viewdirs"]:
        macs += w                    # alpha
        macs += w * w                # feature
        macs += w * (w // 2)         # the view layer's feature columns
        macs += (w // 2) * 3         # rgb
    else:
        macs += w * cfg["output_ch"]
    return macs


def nerf_ray_macs(cfg: Dict) -> int:
    """The view layer's direction columns, once a ray in each pass (3,456)."""
    return cfg["input_ch_views"] * (cfg["width"] // 2) if cfg["use_viewdirs"] else 0


def nerf_point_train_macs(cfg: Dict) -> int:
    """One point's forward and backward: the weight gradients (as many as the
    forward) and the activation gradients, which need neither the first
    layer's input nor the skip layer's embed columns (1,737,600)."""
    fwd = nerf_point_macs(cfg)
    no_dx = cfg["input_ch"] * cfg["width"] * (1 + len(cfg["skips"]))
    return 2 * fwd + fwd - no_dx


def nerf_ray_train_macs(cfg: Dict) -> int:
    """One ray's direction columns in a training pass: the forward product
    and its weight gradient."""
    return 2 * nerf_ray_macs(cfg)


def nerf_samples_per_ray(cfg: Dict) -> int:
    """Points a ray evaluates over both passes: the coarse samples, then the
    coarse and the fine ones together."""
    return cfg["n_samples"] + (cfg["n_samples"] + cfg["n_importance"]
                               if cfg["n_importance"] > 0 else 0)


def passes(cfg: Dict) -> int:
    return 2 if cfg["n_importance"] > 0 else 1


def share(flops: float, seconds: float, peak: float) -> float:
    """Per cent of `peak` that `flops` in `seconds` reach."""
    return 100.0 * flops / (seconds * peak)


def roofline_share(flops: float, nbytes: float, seconds: float,
                   peak: float = PEAK_BF16_FLOPS) -> float:
    """Per cent of a kernel's roofline: the least time the card could take
    (operations at `peak` or bytes at the HBM rate, whichever is longer)
    over the kernel's measured time."""
    return least_time_share(flops / peak, nbytes, seconds)


def least_time_share(compute_s: float, nbytes: float, seconds: float) -> float:
    """Per cent of a roofline whose operations take `compute_s` at their
    peaks: the longer of that and the bytes at the HBM rate, over the
    measured seconds."""
    return 100.0 * max(compute_s, nbytes / PEAK_HBM_BYTES) / seconds


def r2l_weight_count(cfg: Dict) -> int:
    return r2l_forward_macs(cfg) + cfg["width"] * (1 + cfg["n_block"] * cfg["n_learnable"]) \
        + cfg["output_dim"]

