"""Each reference against the program's plain path, at tiny sizes on the
CPU: the cell's own driver runs the program (float32, exact embeds) and its
check compares it with the reference, as a run on the card does."""
from pathlib import Path

import pytest

from perfbench import calibrate

from perfbench.tests._tiny import OVERRIDES

ROOT = Path(__file__).resolve().parents[2]
# float32 on both sides: what is left is the order of operations
TOL = {"rgb_share_over_0.004": 0.0, "rgb_max_gap": 1e-5, "rgb_rms_gap": 1e-6,
       "loss_gap": 1e-5, "first_loss_gap": 1e-5, "last_loss_gap": 1e-5, "grad_gap": 1e-4,
       "change_gap": 1e-4, "pool_gap": 0.0, "coarse_loss_gap": 1e-5,
       "coarse_first_loss_gap": 1e-5, "coarse_last_loss_gap": 1e-5, "coarse_grad_gap": 1e-4,
       "coarse_change_gap": 1e-4, "first_pool_gap": 0.0, "fine_share_over_0.001": 0.0,
       "coarse_rgb_max_gap": 1e-5}


# the float32 cells; the int8 cell's reference is held to the program's
# plain int8 version in test_perfbench_int8.py
@pytest.mark.parametrize("workload", ["r2l_distill", "r2l_serve", "teacher_train"])
def test_reference_matches_the_plain_program(workload):
    got, _ = calibrate.readings(ROOT, workload, 20240611, 0.2, ["program"], device="cpu",
                                overrides=OVERRIDES[workload])
    numbers = got["program"]
    assert numbers
    assert set(numbers) <= set(TOL)
    for name, value in numbers.items():
        assert value <= TOL[name], (name, value)
