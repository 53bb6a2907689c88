"""The operation counts of the rooflines and MFUs, worked by hand."""
import json
from pathlib import Path

from perfbench import yardstick as Y

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
R2L = json.loads((CONFIGS / "r2l_w256d88.json").read_text())
NERF = json.loads((CONFIGS / "nerf_lego.json").read_text())


def test_r2l_forward():
    # head 1008 x 256, 43 blocks of two 256 x 256, tail 256 x 3
    assert Y.r2l_forward_macs(R2L) == 1008 * 256 + 86 * 256 * 256 + 256 * 3 == 5_894_912


def test_r2l_backward_leaves_out_the_input_gradient():
    # every weight gradient plus every activation gradient but the head's input
    assert Y.r2l_backward_macs(R2L) == 5_894_912 + (5_894_912 - 1008 * 256) == 11_531_776


def test_r2l_int8_split():
    # the int8 body and the bf16 head and tail make up the whole forward
    body, head_tail = Y.r2l_int8_macs(R2L)
    assert (body, head_tail) == (86 * 256 * 256, 1008 * 256 + 256 * 3) == (5_636_096, 258_816)
    assert body + head_tail == Y.r2l_forward_macs(R2L)
    # int8 body, its row scales, activation scales and biases in f32, bf16
    # head and tail, their f32 biases
    assert Y.r2l_int8_weight_bytes(R2L) == (5_636_096 + 86 * (256 + 1 + 256) * 4
                                            + 258_816 * 2 + (256 + 3) * 4) == 6_331_236
    # a frame's operations: 1.804 T int8 at 1,979 TOPS, 0.083 TFLOP bf16
    frame_ms = Y.r2l_int8_least_s(R2L, 160_000) * 1e3
    assert abs(frame_ms - (160_000 * 2 * 5_636_096 / 1979e12
                           + 160_000 * 2 * 258_816 / 989e12) * 1e3) < 1e-12
    assert abs(frame_ms - 0.995) < 1e-3


def test_r2l_step_and_frame():
    step = 98_304 * (5_894_912 + 11_531_776) * 2
    assert abs(step / 1e12 - 3.426) < 1e-3
    frame_ms = 160_000 * Y.r2l_forward_macs(R2L) * 2 / Y.PEAK_BF16_FLOPS * 1e3
    assert abs(frame_ms - 1.907) < 1e-3


def test_nerf_point_and_ray():
    # 63 x 256, six 256 x 256 and one (256 + 63) x 256 after the skip,
    # alpha 256, feature 256 x 256, the view layer's feature columns
    # 256 x 128, rgb 128 x 3; the direction columns 27 x 128 once a ray
    per_point = 63 * 256 + 6 * 256 * 256 + 319 * 256 + 256 + 256 * 256 + 256 * 128 + 128 * 3
    assert Y.nerf_point_macs(NERF) == per_point == 589_952
    assert Y.nerf_ray_macs(NERF) == 27 * 128 == 3_456
    assert Y.nerf_samples_per_ray(NERF) == 64 + 192
    frame_ms = (160_000 * 256 * 589_952 + 160_000 * 2 * 3_456) * 2 / Y.PEAK_BF16_FLOPS * 1e3
    assert abs(frame_ms - 48.87) < 0.01


def test_nerf_training_point():
    # weight gradients as many as the forward; activation gradients without
    # the first layer's input and the skip layer's embed columns
    assert Y.nerf_point_train_macs(NERF) == 2 * 589_952 + 589_952 - 2 * 63 * 256 == 1_737_600
    assert Y.nerf_ray_train_macs(NERF) == 2 * 3_456


def test_shares():
    assert Y.share(989e12, 1.0, Y.PEAK_BF16_FLOPS) == 100.0
    # bound by bytes where they take longer than the operations
    assert abs(Y.roofline_share(1.0, 3.35e12, 2.0) - 50.0) < 1e-9
    assert abs(Y.roofline_share(989e12, 1.0, 4.0) - 25.0) < 1e-9
    assert abs(Y.least_time_share(1.0, 3.35e12, 4.0) - 25.0) < 1e-9
    assert abs(Y.least_time_share(2.0, 3.35e12, 4.0) - 50.0) < 1e-9
