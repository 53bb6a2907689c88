"""A teacher that no kernel covers, on the card: lego_noview.txt's profile
(no viewdirs, f32, fast embeds, so that eval_mode turns fused_teacher on)
renders through the unfused path in its own f32, launches no teacher
kernel, and writes the rand shards that the CPU writes, at an f32
tolerance that a bf16 evaluation misses. It imports nothing of the JAX
package, so that it runs on the card's machine too."""
import os

import numpy as np
import pytest
import torch

from efficient_nerf_tpu_torch import create_data as tcd
from efficient_nerf_tpu_torch import factory
from efficient_nerf_tpu_torch.config.options import parse_args
from efficient_nerf_tpu_torch.data.synthetic import make_synthetic_scene
from efficient_nerf_tpu_torch.ops import nerf_forward_fused, sample_pdf_det_fused
from efficient_nerf_tpu_torch.train import save_checkpoint
from efficient_nerf_tpu_torch.utils.logging import Logger

# rows [o, d, rgb]: the rays are computed on each device (f32 trig and
# products an ulp or two apart); rgb through f32 field evals whose embed's
# 2^9 frequency turns those ulps into ~1e-4 rad of phase, and through the
# inverse CDF, whose levels may jump on a few rays (SHARE)
TOL = {"rays": 1e-5, "rgb": 1e-4}
SHARE = 0.01
TEACHER = ["--dataset_type", "blender", "--model_name", "nerf", "--white_bkgd",
           "--half_res", "False", "--N_samples", "4", "--N_importance", "4",
           "--netdepth", "2", "--netwidth", "16", "--netdepth_fine", "2",
           "--netwidth_fine", "16", "--chunk", "4096", "--testskip", "1"]


@pytest.mark.cuda
def test_an_f32_teacher_off_the_kernel_profile_writes_f32_shards_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    scene = str(tmp_path / "scene")
    make_synthetic_scene(scene, n_train=3, n_val=2, n_test=2, H=8, W=8, seed=0)
    b = factory.create_models(parse_args(TEACHER), 2.0, 6.0, device="cpu")
    teacher = save_checkpoint(str(tmp_path / "noview.tar"), b.model)
    rows = {}
    for dev in ("cpu", "cuda"):
        kd = str(tmp_path / f"kd_{dev}")
        args = parse_args(TEACHER + ["--datadir", scene, "--basedir", str(tmp_path / "l"),
                                     "--expname", dev, "--teacher_ckpt", teacher,
                                     "--create_data", "rand", "--datadir_kd",
                                     f"blender:{kd}", "--n_pose_kd", "64",
                                     "--create_data_chunk", "64"])
        launches = (nerf_forward_fused.launches, sample_pdf_det_fused.launches)
        assert tcd.create_data(args, Logger(args, basedir=args.basedir), device=dev) == 1
        assert (nerf_forward_fused.launches, sample_pdf_det_fused.launches) == launches
        rows[dev] = np.load(os.path.join(kd, "data_1.npy"))
    got, want = rows["cuda"], rows["cpu"]
    assert got.shape == want.shape == (4096, 9) and got.dtype == np.float32
    np.testing.assert_allclose(got[:, :6], want[:, :6], atol=TOL["rays"], rtol=0)
    beyond = (np.abs(got[:, 6:] - want[:, 6:]) > TOL["rgb"]).any(-1)
    assert beyond.mean() <= SHARE, (beyond.sum(), np.abs(got - want).max(0))
