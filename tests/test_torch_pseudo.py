"""Pseudo-data generation against the JAX package: the frame renderer's rows
for a random focal scale and each learn_depth, the shuffle buffer, the shard
exporter and the streaming generator's first batches. The JAX side renders
through its fused eval path (its Pallas kernels in interpret mode, switched
on by monkeypatching the JAX ops gate), the path the port's eval mode
takes."""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import efficient_nerf_tpu.ops as jops
from efficient_nerf_tpu.core.poses import random_spherical_pose
from efficient_nerf_tpu.data import pseudo as JP
from efficient_nerf_tpu.ops.pallas import nerf_forward as jnf
from efficient_nerf_tpu.ops.pallas import sample_pdf as jsp
from efficient_nerf_tpu.render.renderer import RenderConfig as JaxRenderConfig
from efficient_nerf_tpu_torch.data import pseudo as P
from efficient_nerf_tpu_torch.models import NeRFMLP
from efficient_nerf_tpu_torch.render import RenderConfig

DEPTH, WIDTH, FOCAL = 8, 64, 9.0
# rays: the divided focal branch of get_rays, bit for bit with the JAX
# package's eager get_rays (tests/test_torch_teacher_core.py); under its jit
# XLA contracts the rotation's multiply-adds into FMAs, which moves an
# element by one f32 ulp now and then. rgb and depth as the renderer's fine
# outputs (tests/test_torch_renderer.py). The coarse weights differ by ~1e-5
# (f32 sums in another order), and the inverse CDF is not continuous where an
# interval's CDF step is below its 1e-5 guard, nor the composite where the
# last sample's sigma (standing for a 1e10-long interval) crosses 0: a level
# or a sigma on such an edge moves a ray's fine pass by much more. So up to
# SHARE of the rows may differ beyond the tolerance (0.4% of a 4096-row
# shard measured).
TOL = {"rays": 4e-7, "rgb": 2e-3, "depth": 1e-2}
SHARE = 0.01
# the int8 teacher: one int8 level that an ulp of the jitted JAX scales moves
# (tests/test_torch_renderer.py, INT8_TOL)
INT8_TOL = {"rays": 4e-7, "rgb": 1e-2, "depth": 5e-2}
CFG = dict(n_samples=16, n_importance=16, white_bkgd=True, chunk=64)


@pytest.fixture
def jax_fused(monkeypatch):
    monkeypatch.setattr(jops, "fused_nerf_available", lambda: True)
    monkeypatch.setattr(jops, "nerf_forward_fused",
                        functools.partial(jnf.nerf_forward_fused, interpret=True))
    monkeypatch.setattr(jops, "sample_pdf_det_fused",
                        functools.partial(jsp.sample_pdf_det_fused, interpret=True))


@pytest.fixture(scope="module")
def models():
    from efficient_nerf_tpu.models import NeRFMLP as JaxNeRFMLP

    rng = np.random.default_rng(0)
    jm = JaxNeRFMLP(depth=DEPTH, width=WIDTH)
    p = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 90)))["params"]
    params = jax.tree_util.tree_map(
        lambda v: (np.asarray(v) + rng.normal(scale=0.05, size=v.shape)
                   ).astype(np.float32), p)
    return jm, params, NeRFMLP(depth=DEPTH, width=WIDTH).load_jax_params(params)


def _compare_rows(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got[:, :6], want[:, :6], atol=tol["rays"], rtol=0)
    diff = np.abs(got - want)
    beyond = (diff[:, 6:9] > tol["rgb"]).any(-1) | (diff[:, 9:] > tol["depth"]).any(-1)
    assert beyond.mean() <= SHARE, (beyond.sum(), diff[:, 6:].max())


@pytest.mark.parametrize("learn_depth", ["", "depth", "surface"])
def test_frame_rows_match_jax(learn_depth, models, jax_fused):
    jm, params, tm = models
    rng = np.random.default_rng(3)
    pose = random_spherical_pose(rng)
    fs = 1.0 + rng.random()
    jfn = JP.make_pseudo_frame_renderer(jm, JaxRenderConfig(**CFG), 8, 8, FOCAL,
                                        learn_depth)
    want = jfn(params, params, jnp.asarray(pose[:3, :4]), jnp.float32(fs), None)
    got = P.make_pseudo_frame_renderer(tm, None, RenderConfig(**CFG), 8, 8, FOCAL,
                                       learn_depth, device="cpu")(pose[:3, :4], fs)
    assert got.shape == (64, {"": 9, "depth": 10, "surface": 12}[learn_depth])
    _compare_rows(got.numpy(), want)


def test_int8_frame_rows_match_jax(models):
    """teacher_quant='int8' reaches the renderer through cfg.eval_mode(): the
    rows against the JAX package's int8 rows (off the TPU its jnp twin, so
    no monkeypatch), and away from the f32 teacher's rows."""
    jm, params, tm = models
    rng = np.random.default_rng(3)
    pose = random_spherical_pose(rng)
    fs = 1.0 + rng.random()
    cfg = dict(CFG, teacher_quant="int8")
    want = JP.make_pseudo_frame_renderer(jm, JaxRenderConfig(**cfg), 8, 8, FOCAL, "depth")(
        params, params, jnp.asarray(pose[:3, :4]), jnp.float32(fs), None)
    got = P.make_pseudo_frame_renderer(tm, None, RenderConfig(**cfg), 8, 8, FOCAL, "depth",
                                       device="cpu")(pose[:3, :4], fs)
    _compare_rows(got.numpy(), want, INT8_TOL)
    f32 = P.make_pseudo_frame_renderer(tm, None, RenderConfig(**CFG), 8, 8, FOCAL, "depth",
                                       device="cpu")(pose[:3, :4], fs)
    assert (f32[:, 6:9] - got[:, 6:9]).abs().max() > TOL["rgb"]


def test_shuffle_buffer_matches_jax():
    rows = np.random.default_rng(1).normal(size=(50, 9)).astype(np.float32)
    a = P.ShuffleBuffer(32, 9, np.random.default_rng(7))
    b = JP.ShuffleBuffer(32, 9, np.random.default_rng(7))
    for lo, hi in ((0, 20), (20, 30), (30, 50), (0, 50)):
        a.add(rows[lo:hi])
        b.add(rows[lo:hi])
        np.testing.assert_array_equal(a.buf[:a.size], b.buf[:b.size])
        np.testing.assert_array_equal(a.sample(11), b.sample(11))
    with pytest.raises(RuntimeError):
        P.ShuffleBuffer(4, 9).sample(1)


def test_export_shards_match_jax(models, jax_fused, tmp_path):
    """4 poses of 32x32: 4096 rows, one shard in each directory, the same
    rows in the same order (both double-shuffle with the same generator)."""
    jm, params, tm = models
    kw = dict(seed=5)
    cfg = dict(CFG, chunk=1024)
    n_j = JP.export_pseudo_shards(jm, params, params, JaxRenderConfig(**cfg), 32, 32,
                                  FOCAL, str(tmp_path / "jax"), 4, **kw)
    n_t = P.export_pseudo_shards(tm, None, RenderConfig(**cfg), 32, 32, FOCAL,
                                 str(tmp_path / "torch"), 4, device="cpu", **kw)
    assert n_j == n_t == 1
    files = sorted(os.listdir(tmp_path / "torch"))
    assert files == sorted(os.listdir(tmp_path / "jax")) == ["data_1.npy"]
    got = np.load(tmp_path / "torch" / files[0])
    assert got.shape == (P.SHARD_ROWS, 9) and got.dtype == np.float32
    _compare_rows(got, np.load(tmp_path / "jax" / files[0]))
    # resuming counts the files already there
    assert P.export_pseudo_shards(tm, None, RenderConfig(**cfg), 32, 32, FOCAL,
                                  str(tmp_path / "torch"), 4, device="cpu", **kw) == 2


def test_streaming_generator_first_batches_match_jax(models, jax_fused):
    jm, params, tm = models
    kw = dict(batch_rays=32, buffer_rays=100, warmup_frames=2, frames_per_batch=0.5)
    j = JP.StreamingPseudoGenerator(jm, params, params, JaxRenderConfig(**CFG), 8, 8,
                                    FOCAL, rng=np.random.default_rng(11), **kw)
    t = P.StreamingPseudoGenerator(tm, None, RenderConfig(**CFG), 8, 8, FOCAL,
                                   rng=np.random.default_rng(11), device="cpu", **kw)
    for _ in range(3):
        got, want = next(t), next(j)
        assert [g.shape for g in got] == [(32, 3), (32, 3), (32, 3)]
        _compare_rows(np.concatenate(got, -1), np.concatenate(want, -1))
    assert t.frames_rendered == j.frames_rendered == 3


def test_scene_pose_sampler():
    s = P.scene_pose_sampler("blender", radius=3.0)
    p = s(np.random.default_rng(0))
    np.testing.assert_allclose(np.linalg.norm(p[:3, 3]), 3.0, rtol=1e-6)
    with pytest.raises(ValueError, match="capture poses"):
        P.scene_pose_sampler("llff")
    with pytest.raises(ValueError, match="learn_depth"):
        P.make_pseudo_frame_renderer(None, None, RenderConfig(), 2, 2, 1.0, "normal",
                                     device="cpu")
    assert torch.is_tensor(P.make_pseudo_frame_renderer(
        NeRFMLP(depth=2, width=64, skips=()), None, RenderConfig(**CFG), 2, 2, 1.0,
        device="cpu")(np.eye(4)[:3], 1.0))
