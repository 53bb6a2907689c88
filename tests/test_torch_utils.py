"""The port's utils, as tests/test_utils_aux.py holds the JAX package's:
the logger's layout and code cache, meters, the profiling and frame timers,
the non-finite finder, the pose plot, and the given-rays eval of
render_path (against the JAX package's on the same weights)."""
import argparse
import os

import numpy as np
import pytest
import torch

from efficient_nerf_tpu_torch.utils import (AverageMeter, LossLine, Logger, Timer,
                                            assert_finite, compiled_cost, count_params,
                                            debug_nans, find_nonfinite, frame_time,
                                            plot_pose_cloud, save_video, trace)


def test_logger_layout_and_code_cache(tmp_path):
    args = argparse.Namespace(project="cachetest", config=None, cache_ignore="ops,data")
    logger = Logger(args, basedir=str(tmp_path))
    for d in (logger.weights_path, logger.gen_img_path, logger.log_path):
        assert os.path.isdir(d)
    assert os.path.basename(logger.exp_path) == f"cachetest_{logger.ExpID}"
    logger.info("hello", 3)
    with open(os.path.join(logger.log_path, "log.txt")) as f:
        assert "hello 3" in f.read()
    root = logger.code_cache_path
    assert os.path.basename(root) == "efficient_nerf_tpu_torch"
    assert os.path.exists(os.path.join(root, "utils", "logging.py"))
    assert os.path.exists(os.path.join(root, "csrc", "r2l_wgmma.cuh"))
    assert not os.path.exists(os.path.join(root, "ops"))
    assert not os.path.exists(os.path.join(root, "data"))
    assert os.path.exists(os.path.join(root, "create_data.py"))


def test_meters():
    m = AverageMeter("t", ":.2f")
    m.update(1.0)
    m.update(3.0)
    assert m.avg == 2.0 and "t 3.00 (2.00)" == str(m)
    ll = LossLine()
    ll.update("psnr", 31.234, ".2f")
    ll.update("tag", "x")
    assert ll.format() == "psnr 31.23 tag x"
    assert isinstance(Timer(10)(), str)
    assert count_params({"a": torch.zeros(2, 3), "b": torch.zeros(5)}) == 11
    bn = torch.nn.BatchNorm2d(4)          # buffers are not parameters
    assert count_params(bn) == 8


def test_timers_and_costs(tmp_path):
    f = lambda x: x * 2.0   # noqa: E731
    cost = compiled_cost(lambda a, b: a @ b, torch.ones(128, 64), torch.ones(64, 32))
    assert cost["flops"] == 2 * 128 * 64 * 32
    dt, spread = frame_time(lambda eps: torch.ones(64, 64) @ torch.ones(64, 64) + eps,
                            torch.device("cpu"), warmup=1, reps=5)
    assert dt > 0 and spread >= 0
    with trace(str(tmp_path / "tr")):
        f(torch.ones(3))
    assert os.path.exists(tmp_path / "tr" / "trace.json")


def test_find_nonfinite_and_debug_nans():
    tree = {"ok": torch.ones(3), "bad": torch.tensor([1.0, float("nan")]),
            "ints": torch.tensor([1, 2])}
    bad = find_nonfinite(tree)
    assert len(bad) == 1 and "bad" in bad[0]
    assert find_nonfinite(torch.nn.Linear(2, 2)) == []
    assert_finite({"x": torch.ones(2)})
    with pytest.raises(FloatingPointError):
        assert_finite(tree)
    x = torch.tensor([-1.0], requires_grad=True)
    with pytest.raises(RuntimeError):
        with debug_nans():
            torch.sqrt(x).sum().backward()


def test_save_video_and_pose_cloud(tmp_path):
    frames = np.random.default_rng(0).uniform(size=(3, 8, 8, 3))
    path = save_video(str(tmp_path / "v.mp4"), frames)
    assert os.path.exists(path)
    if path.endswith(".npz"):     # no mp4 encoder here
        np.testing.assert_array_equal(np.load(path)["frames"],
                                      (255 * frames).astype(np.uint8))
    pytest.importorskip("matplotlib")
    from efficient_nerf_tpu_torch.core.poses import spherical_render_poses

    poses = spherical_render_poses(8)
    assert os.path.exists(plot_pose_cloud(poses, str(tmp_path / "cloud.png"),
                                          other_poses=poses[:4]))


def test_given_rays_eval_matches_jax(tmp_path):
    from efficient_nerf_tpu import evaluate as jeval
    from efficient_nerf_tpu import factory as jfactory
    from efficient_nerf_tpu.config.options import parse_args as jparse
    from efficient_nerf_tpu.models import torch_import
    from efficient_nerf_tpu_torch import evaluate, factory
    from efficient_nerf_tpu_torch.config.options import parse_args
    from efficient_nerf_tpu_torch.core.poses import pose_spherical
    from efficient_nerf_tpu_torch.core.rays import get_rays_np

    H = W = 8
    o1, d1 = get_rays_np(H, W, 8.0, pose_spherical(0, -30, 4.0)[:3, :4])
    o2, d2 = get_rays_np(H, W, 8.0, pose_spherical(40, -30, 4.0)[:3, :4])
    gt = np.random.default_rng(0).uniform(size=(2, H, W, 3)).astype(np.float32)
    path = str(tmp_path / "rays.npz")
    np.savez(path, all_rays_o=np.stack([o1.reshape(-1, 3), o2.reshape(-1, 3)]),
             all_rays_d=np.stack([d1.reshape(-1, 3), d2.reshape(-1, 3)]), gt_imgs=gt)
    go, gd, ggt = evaluate.load_given_rays(path)
    assert go.shape == (2, 64, 3) and ggt.shape == gt.shape
    argv = ["--model_name", "R2L", "--n_sample_per_ray", "4", "--netdepth", "6",
            "--netwidth", "32", "--dataset_type", "blender", "--trial.ON",
            "--trial.body_arch", "resmlp"]
    bundle = factory.create_models(parse_args(argv), 2.0, 6.0, device="cpu")
    jb = jfactory.create_models(jparse(argv), 2.0, 6.0)
    params = torch_import.r2l_params_from_state_dict(bundle.model.state_dict(), n_block=2)
    jb = jb._replace(params=params)
    kw = dict(model_name="r2l", n_sample_per_ray=4, gt_imgs=ggt, given_rays=(go, gd),
              log=lambda *a: None)
    out = evaluate.render_path(bundle, [None, None], (H, W, 8.0), **kw)
    want = jeval.render_path(jb, [None, None], (H, W, 8.0), **kw)
    assert out["rgbs"].shape == (2, H, W, 3)
    np.testing.assert_allclose(out["rgbs"], want["rgbs"], atol=1e-5)
    assert out["test_psnr"] == pytest.approx(want["test_psnr"], abs=1e-4)
    # int8 serving calibrates once, on the first given-ray frame
    out8 = evaluate.render_path(bundle, [None, None], (H, W, 8.0), quant="int8", **kw)
    assert np.isfinite(out8["test_psnr"])
