"""On the card: the control of each cell (the program's own lower-precision
path, or the reference one precision below the configuration's in the
program's place) fails the cell's limits on three seeds, while the program
passes them. Each seed runs the cell's set-up and a short window at the
cell's own sizes."""
import math
from pathlib import Path

import pytest
import torch

from perfbench import calibrate

ROOT = Path(__file__).resolve().parents[2]
SEEDS = (3141592653, 2718281828, 1414213562)


def passes(numbers, limits) -> bool:
    return all(math.isfinite(numbers.get(k, math.inf)) and numbers[k] <= v
               for k, v in limits.items())


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["r2l_serve", "r2l_distill", "teacher_train",
                                      "r2l_serve_int8"])
def test_control_fails_and_program_passes(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed in SEEDS:
        got, limits = calibrate.readings(ROOT, workload, seed, 2.0, ["program", "control"],
                                         device="cuda")
        assert passes(got["program"], limits), (seed, got["program"], limits)
        assert not passes(got["control"], limits), (seed, got["control"], limits)
