"""The port's option system against the JAX package's: the same `vars()` for
the argv of the JAX driver tests and for every scene config, and the scene
configs written byte for byte as the JAX generator writes them."""
import filecmp
import os

import pytest

from efficient_nerf_tpu.config import gen_scene_configs as jgen
from efficient_nerf_tpu.config import options as jopt
from efficient_nerf_tpu_torch.config import SCENES_DIR, gen_scene_configs, options

BLENDER = ["--datadir", "/tmp/scene", "--dataset_type", "blender", "--basedir", "/tmp/logs"]
# the argv of tests/test_main.py and tests/test_create_data.py
ARGVS = [
    BLENDER + ["--expname", "minitest", "--white_bkgd", "--half_res", "False",
               "--N_samples", "4", "--N_importance", "4", "--netdepth", "2",
               "--netwidth", "16", "--netdepth_fine", "2", "--netwidth_fine", "16",
               "--N_rand", "32", "--chunk", "64", "--i_print", "2", "--i_testset", "4",
               "--i_video", "1000000", "--i_weights", "4", "--testskip", "1",
               "--n_pose_video", "2", "--model_name", "nerf", "--use_viewdirs",
               "--precrop_iters", "2", "--precrop_frac", "0.5"],
    BLENDER + ["--model_name", "R2L", "--data_mode", "rays", "--datadir_kd",
               "blender:/tmp/kd", "--n_sample_per_ray", "4", "--N_rand", "1",
               "--netdepth", "4", "--netwidth", "16", "--hard_ratio", "0.1",
               "--hard_mul", "2", "--use_residual"],
    BLENDER + ["--model_name", "R2L", "--stream_pseudo_data", "--teacher_ckpt", "/tmp/c",
               "--render_only", "--render_test", "--convert_to_onnx", "--benchmark",
               "--hard_ratio", "0.2,0.4", "--n_pose_video", "sample:4,fix:-30,fix:4"],
    BLENDER + ["--model_name", "R2L", "--data_mode", "images", "--precrop_iters", "10",
               "--select_pixel_mode", "rand_patch", "--pseudo_ratio_schedule",
               "1:0.2,500:0.9", "--warmup_lr", "0.0001,200", "--trial.ON",
               "--trial.body_arch", "resmlp", "--trial.res_scale", "0.5",
               "--trial.n_block", "3", "--trial.near", "1.5", "--trial.far", "5"],
    BLENDER + ["--model_name", "nerf", "--teacher_ckpt", "/tmp/c", "--create_data",
               "16x16patches", "--datadir_kd", "blender:/tmp/kd", "--n_pose_kd", "2",
               "--create_data_chunk", "1", "--patch_items_per_shard", "8",
               "--test_teacher", "--no_rand_focal", "--teacher_quant", "int8",
               "--inference_quant", "int8", "--no_pallas", "--compute_dtype", "bf16"],
    BLENDER + ["--model_name", "R2L", "--data_mode", "patches", "--kernel_size", "3",
               "--body_arch", "resblock", "--use_bn", "--N_iters", "3", "--lrate", "5e-4",
               "--hard_ratio", "", "--n_pose_kd", "none", "--mesh_data", "2",
               "--mesh_model", "2"],
]
SCENES = sorted(f for f in os.listdir(SCENES_DIR) if f.endswith(".txt"))


def _vars(args):
    d = dict(vars(args))
    d["trial"] = vars(d["trial"])
    return d


def _same(argv):
    got, want = _vars(options.parse_args(argv)), _vars(jopt.parse_args(argv))
    assert got == want
    return got


@pytest.mark.parametrize("i", range(len(ARGVS)))
def test_driver_argv_parses_as_in_jax(i):
    _same(ARGVS[i])


def test_every_scene_config_parses_as_in_jax():
    assert len(SCENES) == 57
    for name in SCENES:
        got = _same(["--config", os.path.join(SCENES_DIR, name), "--N_rand", "7"])
        assert got["N_rand"] == 7   # the command line overrides the file


def test_config_file_and_coercions(tmp_path):
    cfg = tmp_path / "scene.txt"
    cfg.write_text("N_rand = 777\nuse_viewdirs = True # comment\ndatadir = ./data/x\n")
    args = _same(["--config", str(cfg), "--N_samples", "8"])
    assert args["N_rand"] == 777 and args["use_viewdirs"] is True
    args = _same(["--hard_ratio", "0.2,0.4", "--n_pose_video", "sample:4,fix:-30,fix:4"])
    assert args["hard_ratio"] == [0.2, 0.4]
    assert args["n_pose_video"] == ["sample:4", "fix:-30", "fix:4"]
    assert options.check_n_pose("none") is None and options.check_n_pose("40") == 40
    bad = tmp_path / "bad.txt"
    bad.write_text("no equals sign here\n")
    with pytest.raises(ValueError, match="bad config line"):
        options.parse_args(["--config", str(bad)])


def test_scene_configs_generate_the_jax_files(tmp_path):
    assert gen_scene_configs.generate(str(tmp_path / "port")) == 57
    assert jgen.generate(str(tmp_path / "jax")) == 57
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == SCENES
    match, mismatch, errors = filecmp.cmpfiles(tmp_path / "port", tmp_path / "jax", names,
                                               shallow=False)
    assert not mismatch and not errors
    # and those are the files both drivers read
    match, mismatch, errors = filecmp.cmpfiles(tmp_path / "port", SCENES_DIR, names,
                                               shallow=False)
    assert not mismatch and not errors
