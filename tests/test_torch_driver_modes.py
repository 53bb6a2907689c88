"""The port's driver in its other modes, on the CPU at tiny sizes: the
streamed student from a teacher checkpoint (the port's `.tar` and the JAX
package's ENTPUCK1), images mode's pixel batches
and precrop, the conv student through --data_mode patches (train, then
render from its checkpoint), --test_pretrained, and --no_pallas passed
down to the step and the renderers as an explicit switch."""
import glob
import os

import numpy as np

from efficient_nerf_tpu_torch import main as tmain
from efficient_nerf_tpu_torch.config.options import parse_args
from efficient_nerf_tpu_torch.utils.logging import Logger

BASE = ["--dataset_type", "blender", "--white_bkgd", "--half_res", "False",
        "--N_samples", "4", "--N_importance", "4", "--netdepth_fine", "2",
        "--netwidth_fine", "16", "--chunk", "64", "--i_print", "1",
        "--i_video", "1000000", "--testskip", "1", "--n_pose_video", "2"]
STUDENT = ["--model_name", "R2L", "--n_sample_per_ray", "4", "--netdepth", "4",
           "--netwidth", "16", "--multires", "4"]


def _args(blender_dir, tmp_path, name, extra):
    return parse_args(["--datadir", blender_dir, "--basedir", str(tmp_path / "logs"),
                       "--expname", name] + BASE + extra)


def _train(args, **kw):
    return tmain.train(args, Logger(args, basedir=args.basedir), device="cpu", **kw)


def _weights(tmp_path, name, file="ckpt.tar"):
    (path,) = glob.glob(str(tmp_path / "logs" / "Experiments" / f"{name}_*" / "weights" / file))
    return path


def test_streaming_student_from_a_teacher_checkpoint(blender_dir, tmp_path):
    _train(_args(blender_dir, tmp_path, "teacher",
                 ["--model_name", "nerf", "--use_viewdirs", "--netdepth", "2",
                  "--netwidth", "16", "--N_rand", "16", "--i_weights", "2",
                  "--i_testset", "1000000"]), max_iters=2)
    ckpt = _weights(tmp_path, "teacher")
    # the student's flags name another teacher architecture: the checkpoint's
    # model_config rebuilds the right one
    state = _train(_args(blender_dir, tmp_path, "stream",
                         STUDENT + ["--stream_pseudo_data", "--teacher_ckpt", ckpt,
                                    "--N_rand", "1", "--i_testset", "1000000",
                                    "--i_weights", "1000000", "--stream_warmup_frames", "2",
                                    "--netdepth_fine", "5"]), max_iters=3)
    assert state.step == 3


def test_streaming_student_from_a_jax_entpuck1_teacher(blender_dir, tmp_path):
    from efficient_nerf_tpu import factory as jfactory
    from efficient_nerf_tpu import main as jmain
    from efficient_nerf_tpu.config.options import parse_args as jparse
    from efficient_nerf_tpu.train.checkpoints import save_checkpoint as jax_save

    teacher = BASE + ["--model_name", "nerf", "--use_viewdirs", "--netdepth", "2",
                      "--netwidth", "16"]
    jargs = jparse(teacher)
    jb = jfactory.create_models(jargs, 2.0, 6.0)
    ckpt = jax_save(str(tmp_path / "teacher.msgpack"), jb.params, step=2,
                    model_config=jmain._model_config(jargs))
    # the header's model_config rebuilds the teacher, as from a port .tar
    state = _train(_args(blender_dir, tmp_path, "stream",
                         STUDENT + ["--stream_pseudo_data", "--teacher_ckpt", ckpt,
                                    "--N_rand", "1", "--i_testset", "1000000",
                                    "--i_weights", "1000000", "--stream_warmup_frames", "2",
                                    "--netdepth_fine", "5"]), max_iters=3)
    assert state.step == 3


def test_images_mode_nrand_and_precrop(blender_dir, tmp_path, monkeypatch):
    from efficient_nerf_tpu_torch.data.images_dataset import setup_image_datadir

    kd_dir = str(tmp_path / "kd_images")
    setup_image_datadir(blender_dir, kd_dir)
    args = _args(blender_dir, tmp_path, "images",
                 STUDENT + ["--data_mode", "images", "--datadir_kd", f"blender:{kd_dir}",
                            "--N_rand", "7", "--precrop_iters", "10", "--precrop_frac", "0.5"])
    logger = Logger(args, basedir=args.basedir)
    scene = tmain.load_scene(args)
    seen = []
    orig = tmain._select_coords

    def spy(rng, H, W, n_rand, mode, precrop_frac=None):
        seen.append((n_rand, precrop_frac))
        return orig(rng, H, W, n_rand, mode, precrop_frac)

    monkeypatch.setattr(tmain, "_select_coords", spy)
    next_batch, reload, close = tmain._make_r2l_data_iterator(
        args, scene, np.random.default_rng(0), logger, "cpu")
    o, d, t = next_batch(5)            # inside the precrop warmup
    assert o.shape == d.shape == t.shape == (7, 3)
    assert seen[-1] == (7, 0.5)
    next_batch(10)                     # warmup over
    assert seen[-1] == (7, None)
    assert reload(3) is False
    close()
    state = _train(_args(blender_dir, tmp_path, "images_train",
                         STUDENT + ["--data_mode", "images", "--datadir_kd",
                                    f"blender:{kd_dir}", "--N_rand", "16",
                                    "--i_testset", "1000000", "--i_weights", "1000000"]),
                   max_iters=3)
    assert state.step == 3


def test_conv_student_trains_and_renders_through_the_driver(blender_dir, tmp_path):
    from efficient_nerf_tpu_torch.create_data import create_data

    _train(_args(blender_dir, tmp_path, "teacher",
                 ["--model_name", "nerf", "--use_viewdirs", "--netdepth", "2",
                  "--netwidth", "16", "--N_rand", "16", "--i_weights", "1",
                  "--i_testset", "1000000"]), max_iters=1)
    kd = str(tmp_path / "kd_patch")
    cargs = _args(blender_dir, tmp_path, "cd",
                  ["--model_name", "nerf", "--use_viewdirs", "--netdepth", "2",
                   "--netwidth", "16", "--teacher_ckpt", _weights(tmp_path, "teacher"),
                   "--create_data", "3x3rays", "--datadir_kd", f"blender:{kd}",
                   "--n_pose_kd", "2", "--patch_items_per_shard", "4"])
    assert create_data(cargs, device="cpu") >= 1
    conv = STUDENT + ["--data_mode", "patches", "--kernel_size", "3", "--body_arch",
                      "resblock", "--use_bn"]
    state = _train(_args(blender_dir, tmp_path, "conv",
                         conv + ["--datadir_kd", f"blender:{kd}", "--N_rand", "1",
                                 "--i_testset", "3", "--i_weights", "3"]), max_iters=3)
    assert state.step == 3 and int(state.model.head_bn.num_batches_tracked) == 3
    ckpt = _weights(tmp_path, "conv")
    args = _args(blender_dir, tmp_path, "conv_rt",
                 conv + ["--pretrained_ckpt", ckpt, "--render_only", "--render_test"])
    misc = _train(args)
    assert misc["rgbs"].shape == (2, 8, 8, 3) and np.isfinite(misc["test_psnr"])
    # the running statistics came back with the weights
    from efficient_nerf_tpu_torch.train import load_checkpoint
    sd = load_checkpoint(ckpt)["network_fn_state_dict"]
    assert int(sd["head_bn.num_batches_tracked"]) == 3


def test_test_pretrained_and_no_pallas_switches(blender_dir, tmp_path, monkeypatch,
                                                 capsys):
    seen = {}
    for name in ("make_r2l_train_step", "render_path"):
        orig = getattr(tmain, name)

        def spy(*a, _orig=orig, _name=name, **kw):
            seen.setdefault(_name, []).append(kw)
            return _orig(*a, **kw)

        monkeypatch.setattr(tmain, name, spy)
    from efficient_nerf_tpu_torch.data import rays_to_shards

    rng = np.random.default_rng(0)
    rows = np.concatenate([rng.normal(size=(4096, 6)), rng.uniform(size=(4096, 3))],
                          -1).astype(np.float32)
    kd = str(tmp_path / "kd")
    rays_to_shards(rows, kd, prefix="data_")
    state = _train(_args(blender_dir, tmp_path, "nopallas",
                         STUDENT + ["--data_mode", "rays", "--datadir_kd", f"blender:{kd}",
                                    "--N_rand", "1", "--no_pallas", "--test_pretrained",
                                    "--i_testset", "2", "--i_weights", "1000000"]),
                   max_iters=2)
    assert state.step == 2
    assert seen["make_r2l_train_step"][0]["fused"] is False
    assert len(seen["render_path"]) == 2     # --test_pretrained, then i_testset
    assert all(kw["allow_fused"] is False for kw in seen["render_path"])
    assert "Pretrained test: TestLoss" in capsys.readouterr().out
