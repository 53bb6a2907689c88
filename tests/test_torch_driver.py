"""The port's driver against the JAX driver, on the CPU in f32: both run
from one initial `.tar` (--perturb 0 --raw_noise_std 0 --exact_embed, so
that no device draw enters) on the miniature blender scene; the teacher and
the R2L student in rays mode take 3 steps each (the same batches: one host
generator in the same order), with the same losses and final weights;
--render_only --render_test gives the same PSNR/SSIM; --benchmark logs its
[BENCH] line; --convert_to_onnx writes and verifies its program."""
import os

import numpy as np
import pytest
import torch

from efficient_nerf_tpu import main as jmain
from efficient_nerf_tpu.config.options import parse_args as jparse
from efficient_nerf_tpu.models import torch_import
from efficient_nerf_tpu.utils.logging import Logger as JaxLogger
from efficient_nerf_tpu_torch import factory
from efficient_nerf_tpu_torch import main as tmain
from efficient_nerf_tpu_torch.config.options import parse_args
from efficient_nerf_tpu_torch.train import save_checkpoint
from efficient_nerf_tpu_torch.utils.logging import Logger

# The first step's loss: the same f32 fields summed in another order (the
# student's 2e-6 relative apart). Weights after Adam, as max |port - JAX|
# in units of lr: Adam maps each gradient to about +-lr whatever its size,
# so a gradient component within the two packages' disagreement moves its
# weight by a part of one lr. The student's gradients agree tightly:
# measured at most 0.017 lr after 3 steps (body.0's first weight, 4.7e-5 of
# its largest entry; head.0 0.004 lr), held at about three times that. The
# teacher's fine network sees its depths through the inverse CDF, whose f32
# sums run in another order (a stated divergence, ROADMAP queue 3), and the
# embed's 2^9 frequency turns that into gradient noise: measured 0.044 lr
# (1.7e-4 of the largest entry) on the fine pts_linears.0 after the first
# step and no more after 3, the coarse network at most 0.003 lr; the later
# losses then differ by up to 2.2e-5 relative. The student's losses agree
# to 1e-5.
LOSS_RTOL = {"student": 1e-5, "teacher": 5e-5}
WEIGHT_TOL_LR = {"student": 0.05, "teacher": 0.1}
LR = 5e-4           # --lrate's default
# the test frames: PSNR, SSIM and FLIP as the issue's 1e-4; the teacher's
# pixels through the inverse CDF above, within the pseudo rows' 2e-3
# (tests/test_torch_pseudo.py)
METRIC_TOL = 1e-4

COMMON = ["--dataset_type", "blender", "--white_bkgd", "--half_res", "False",
          "--N_samples", "4", "--N_importance", "4", "--chunk", "64",
          "--i_print", "1", "--i_testset", "1000000", "--i_video", "1000000",
          "--i_weights", "1000000", "--testskip", "1", "--n_pose_video", "2",
          "--perturb", "0", "--raw_noise_std", "0", "--exact_embed", "--num_workers", "0"]
TEACHER = ["--model_name", "nerf", "--use_viewdirs", "--netdepth", "2", "--netwidth", "16",
           "--netdepth_fine", "2", "--netwidth_fine", "16", "--N_rand", "32"]
STUDENT = ["--model_name", "R2L", "--n_sample_per_ray", "4", "--netdepth", "6",
           "--netwidth", "32", "--trial.ON", "--trial.body_arch", "resmlp", "--use_residual",
           "--multires", "4"]


def _argv(blender_dir, tmp_path, name, extra):
    return ["--datadir", blender_dir, "--basedir", str(tmp_path / "logs"),
            "--expname", name] + COMMON + extra


def _init_tar(tmp_path, argv):
    b = factory.create_models(parse_args(argv), 2.0, 6.0, device="cpu")
    path = str(tmp_path / "init.tar")
    return save_checkpoint(path, b.model)


def _record(monkeypatch, module, builder, losses, key):
    make = getattr(module, builder)

    def wrapped(*a, **kw):
        step = make(*a, **kw)

        def recorded(*sa, **skw):
            out = step(*sa, **skw)
            losses.append(float(out[-1][key]))
            return out

        return recorded

    monkeypatch.setattr(module, builder, wrapped)


def _run_both(monkeypatch, blender_dir, tmp_path, extra, builder, key, model):
    argv = _argv(blender_dir, tmp_path, "init", extra)
    init = _init_tar(tmp_path, argv)
    mine, theirs = [], []
    _record(monkeypatch, tmain, builder, mine, key)
    _record(monkeypatch, jmain, builder, theirs, key)
    targs = parse_args(_argv(blender_dir, tmp_path, "port", extra)
                       + ["--pretrained_ckpt", init, "--N_iters", "3"])
    state = tmain.train(targs, Logger(targs, basedir=targs.basedir), device="cpu")
    jargs = jparse(_argv(blender_dir, tmp_path, "jax", extra)
                   + ["--pretrained_ckpt", init, "--N_iters", "3"])
    jstate = jmain.train(jargs, JaxLogger(jargs, basedir=jargs.basedir))
    assert state.step == int(jstate.step) == 3 and len(mine) == len(theirs) == 3
    np.testing.assert_allclose(mine, theirs, rtol=LOSS_RTOL[model])
    return state, jstate


def _weights_agree(got_sd, want_sd, model):
    assert set(got_sd) == set(want_sd)
    for k, v in want_sd.items():
        err = np.abs(got_sd[k].detach().numpy() - v).max() / LR
        assert err <= WEIGHT_TOL_LR[model], (k, err)


@pytest.mark.parametrize("batching", [True, False])
def test_teacher_steps_match_the_jax_driver(batching, blender_dir, tmp_path, monkeypatch):
    extra = TEACHER + ([] if batching else ["--no_batching", "--precrop_iters", "2",
                                            "--precrop_frac", "0.5", "--N_rand", "16"])
    state, jstate = _run_both(monkeypatch, blender_dir, tmp_path, extra,
                              "make_teacher_train_step", "loss", "teacher")
    for name in ("coarse", "fine"):
        want = torch_import.nerf_state_dict_from_params(jstate.params[name], depth=2)
        _weights_agree(state.model[name].state_dict(), want, "teacher")


@pytest.fixture
def shard_dir(tmp_path):
    """Reference-format ray shards of random rows (tests/test_main.py's)."""
    from efficient_nerf_tpu_torch.data import rays_to_shards

    rng = np.random.default_rng(0)
    rows = np.concatenate([rng.normal(size=(4096 * 2, 6)).astype(np.float32),
                           rng.uniform(size=(4096 * 2, 3)).astype(np.float32)], -1)
    out = str(tmp_path / "kd_rays")
    rays_to_shards(rows, out, prefix="train_")
    rays_to_shards(rows[::-1].copy(), out, prefix="data_")
    return out


def test_student_rays_steps_match_the_jax_driver(blender_dir, shard_dir, tmp_path,
                                                 monkeypatch):
    extra = STUDENT + ["--data_mode", "rays", "--datadir_kd", f"blender:{shard_dir}",
                       "--N_rand", "1"]
    state, jstate = _run_both(monkeypatch, blender_dir, tmp_path, extra,
                              "make_r2l_train_step", "loss_rgb", "student")
    want = torch_import.r2l_state_dict_from_params(jstate.params)
    _weights_agree(state.model.state_dict(), want, "student")


def _log(logger):
    with open(os.path.join(logger.log_path, "log.txt")) as f:
        return f.read()


@pytest.mark.parametrize("model", ["student", "teacher"])
def test_render_test_matches_the_jax_driver(model, blender_dir, tmp_path):
    extra = (STUDENT if model == "student" else TEACHER) + ["--render_only", "--render_test"]
    init = _init_tar(tmp_path, _argv(blender_dir, tmp_path, "init", extra))
    targs = parse_args(_argv(blender_dir, tmp_path, "port", extra) + ["--pretrained_ckpt", init])
    logger = Logger(targs, basedir=targs.basedir)
    got = tmain.train(targs, logger, device="cpu")
    jargs = jparse(_argv(blender_dir, tmp_path, "jax", extra) + ["--pretrained_ckpt", init])
    want = jmain.train(jargs, JaxLogger(jargs, basedir=jargs.basedir))
    for k in ("test_psnr", "test_psnr_v2", "test_ssim", "test_flip"):
        assert got[k] == pytest.approx(want[k], abs=METRIC_TOL), k
    assert np.isnan(got["test_lpips"]) and np.isnan(want["test_lpips"])
    np.testing.assert_allclose(got["rgbs"], want["rgbs"], atol=1e-5 if model == "student"
                               else 2e-3)
    pngs = sorted(f for f in os.listdir(logger.gen_img_path) if f.endswith(".png"))
    assert pngs == ["000.png", "000_error.png", "000_gt.png", "001.png", "001_error.png",
                    "001_gt.png"]
    assert "[TEST] PSNR" in _log(logger)
    video = [f for f in os.listdir(logger.gen_img_path) if f.startswith("video_")]
    assert len(video) == 1 and video[0].endswith((".mp4", ".mp4.npz"))


def test_benchmark_and_export(blender_dir, tmp_path):
    argv = _argv(blender_dir, tmp_path, "bench", STUDENT + ["--benchmark"])
    args = parse_args(argv)
    logger = Logger(args, basedir=args.basedir)
    dt = tmain.train(args, logger, device="cpu")
    assert np.isfinite(dt) and dt > 0
    assert "[BENCH] frame" in _log(logger)
    args = parse_args(_argv(blender_dir, tmp_path, "export", STUDENT + ["--convert_to_onnx"]))
    path = tmain.train(args, Logger(args, basedir=args.basedir), device="cpu")
    assert path.endswith("model.pt2") and os.path.exists(path)
    program = torch.export.load(path).module()
    x = torch.zeros((3, 3 * 4 * 9))
    assert program(x).shape == (3, 3)


def test_entry_points_need_a_card_unless_asked_for_the_cpu(blender_dir, tmp_path):
    from efficient_nerf_tpu_torch import create_data as tcd

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    argv = _argv(blender_dir, tmp_path, "nocard", STUDENT + ["--benchmark"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmain.main(argv)
    args = parse_args(argv)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmain.train(args, Logger(args, basedir=args.basedir))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcd.main(_argv(blender_dir, tmp_path, "nocard", TEACHER))
    assert np.isfinite(tmain.main(argv, device="cpu"))
