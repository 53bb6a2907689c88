"""The port's create_data driver against the JAX one, from one teacher
`.tar` on the miniature blender scene (CPU, f32, exact embeds: both take
their unfused eval path): the rand shards, the image modes' poses and
frames, and the patch modes' shards; the int8 teacher and --test_teacher;
the rand shards from the JAX package's own ENTPUCK1 teacher file."""
import json
import os

import numpy as np
import pytest

from efficient_nerf_tpu import create_data as jcd
from efficient_nerf_tpu.config.options import parse_args as jparse
from efficient_nerf_tpu.utils.logging import Logger as JaxLogger
from efficient_nerf_tpu_torch import create_data as tcd
from efficient_nerf_tpu_torch import factory
from efficient_nerf_tpu_torch.config.options import parse_args
from efficient_nerf_tpu_torch.train import save_checkpoint
from efficient_nerf_tpu_torch.utils.logging import Logger

# rows as tests/test_torch_pseudo.py holds them: the rays to a few ulps,
# rgb and depth through the inverse CDF (f32 sums in another order) and
# the composite, within TOL but for a SHARE of the rows
TOL = {"rays": 4e-7, "rgb": 2e-3, "depth": 1e-2}
SHARE = 0.01

TEACHER = ["--dataset_type", "blender", "--model_name", "nerf", "--use_viewdirs",
           "--white_bkgd", "--half_res", "False", "--N_samples", "4", "--N_importance", "4",
           "--netdepth", "2", "--netwidth", "16", "--netdepth_fine", "2",
           "--netwidth_fine", "16", "--chunk", "4096", "--testskip", "1", "--exact_embed"]


@pytest.fixture
def teacher(tmp_path):
    b = factory.create_models(parse_args(TEACHER), 2.0, 6.0, device="cpu")
    return save_checkpoint(str(tmp_path / "teacher.tar"), b.model)


def _both(blender_dir, tmp_path, teacher, mode, extra=()):
    out = {}
    for name, parse, run, log in (("port", parse_args, tcd.create_data, Logger),
                                  ("jax", jparse, jcd.create_data, JaxLogger)):
        kd = str(tmp_path / f"kd_{name}")
        args = parse(TEACHER + ["--datadir", blender_dir, "--basedir", str(tmp_path / "logs"),
                                "--expname", f"cd_{name}", "--teacher_ckpt", teacher,
                                "--create_data", mode, "--datadir_kd", f"blender:{kd}",
                                *extra])
        kw = {"device": "cpu"} if name == "port" else {}
        out[name] = (run(args, log(args, basedir=args.basedir), **kw), kd)
    return out["port"], out["jax"]


def _compare_rows(got, want, tol=TOL):
    assert got.shape == want.shape and got.dtype == want.dtype
    got, want = got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1])
    np.testing.assert_allclose(got[:, :6], want[:, :6], atol=tol["rays"], rtol=0)
    diff = np.abs(got - want)
    beyond = (diff[:, 6:9] > tol["rgb"]).any(-1) | (diff[:, 9:] > tol["depth"]).any(-1)
    assert beyond.mean() <= SHARE, (beyond.sum(), diff[:, 6:].max())


def _shards(kd):
    return sorted(f for f in os.listdir(kd) if f.endswith(".npy"))


def test_rand_shards_match_jax(blender_dir, tmp_path, teacher):
    # 64 poses of 8x8 rays: one 4096-row shard
    (n, kd), (jn, jkd) = _both(blender_dir, tmp_path, teacher, "rand",
                               ["--n_pose_kd", "64", "--create_data_chunk", "64"])
    assert n == jn == 1
    assert _shards(kd) == _shards(jkd) == ["data_1.npy"]
    _compare_rows(np.load(os.path.join(kd, "data_1.npy")),
                  np.load(os.path.join(jkd, "data_1.npy")))


def test_rand_shards_from_a_jax_entpuck1_teacher(blender_dir, tmp_path):
    from efficient_nerf_tpu import factory as jfactory
    from efficient_nerf_tpu.train.checkpoints import save_checkpoint as jax_save

    jb = jfactory.create_models(jparse(TEACHER), 2.0, 6.0)
    teacher = jax_save(str(tmp_path / "teacher.msgpack"), jb.params,
                       jb.optimizer.init(jb.params), step=9)
    (n, kd), (jn, jkd) = _both(blender_dir, tmp_path, teacher, "rand",
                               ["--n_pose_kd", "64", "--create_data_chunk", "64"])
    assert n == jn == 1
    _compare_rows(np.load(os.path.join(kd, "data_1.npy")),
                  np.load(os.path.join(jkd, "data_1.npy")))


@pytest.mark.parametrize("mode", ["spiral_evenly_spaced", "rand_images"])
def test_image_modes_match_jax(mode, blender_dir, tmp_path, teacher):
    (n, kd), (jn, jkd) = _both(blender_dir, tmp_path, teacher, mode, ["--n_pose_kd", "2"])
    assert n == jn == 2
    frames = json.load(open(os.path.join(kd, "transforms_train.json")))["frames"]
    jframes = json.load(open(os.path.join(jkd, "transforms_train.json")))["frames"]
    assert [f["file_path"] for f in frames] == [f["file_path"] for f in jframes]
    assert len(frames) == 5   # 3 real + 2 pseudo
    for f, jf in zip(frames, jframes):
        np.testing.assert_array_equal(np.float32(f["transform_matrix"]),
                                      np.float32(jf["transform_matrix"]))
        img = np.load(os.path.join(kd, f["file_path"] + ".npy"))
        jimg = np.load(os.path.join(jkd, jf["file_path"] + ".npy"))
        assert img.shape == jimg.shape
        np.testing.assert_allclose(img, jimg, atol=TOL["rgb"], rtol=0)


@pytest.mark.parametrize("mode,shape", [("rand_tworays", (1, 2)), ("3x3rays", (3, 3)),
                                        ("16x16patches", (16, 16))])
def test_patch_modes_match_jax(mode, shape, blender_dir, tmp_path, teacher):
    extra = ["--n_pose_kd", "2", "--create_data_chunk", "1", "--patch_items_per_shard", "4"]
    (n, kd), (jn, jkd) = _both(blender_dir, tmp_path, teacher, mode, extra)
    assert n == jn
    assert _shards(kd) == _shards(jkd)
    if shape == (16, 16):          # 8x8 frames hold no 16x16 patch
        assert n == 0
        return
    assert n >= 1
    for f in _shards(kd):
        got, want = np.load(os.path.join(kd, f)), np.load(os.path.join(jkd, f))
        assert got.shape == (4,) + shape + (9,)
        _compare_rows(got, want)


def test_int8_teacher_and_test_teacher(blender_dir, tmp_path):
    # the int8 field eval takes the teacher profile: a skip before a
    # following layer
    b = factory.create_models(parse_args(TEACHER + ["--skips", "0"]), 2.0, 6.0, device="cpu")
    teacher = save_checkpoint(str(tmp_path / "teacher0.tar"), b.model)
    kd = str(tmp_path / "kd8")
    args = parse_args(TEACHER + ["--datadir", blender_dir, "--basedir", str(tmp_path / "l"),
                                 "--teacher_ckpt", teacher, "--create_data", "3x3rays",
                                 "--datadir_kd", f"blender:{kd}", "--n_pose_kd", "1",
                                 "--patch_items_per_shard", "4",
                                 "--teacher_quant", "int8", "--test_teacher",
                                 "--skips", "0"])
    logger = Logger(args, basedir=args.basedir)
    assert tcd.create_data(args, logger, device="cpu") >= 1
    with open(os.path.join(logger.log_path, "log.txt")) as f:
        assert "[TEST TEACHER] PSNR" in f.read()
    with pytest.raises(ValueError, match="teacher_ckpt"):
        tcd.create_data(parse_args(TEACHER + ["--datadir", blender_dir, "--basedir",
                                              str(tmp_path / "l")]), device="cpu")
