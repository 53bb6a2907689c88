"""The port's data path against the JAX package's: get_rays_np and the
synthetic sphere (bit for bit), the shard converter, RayShardDataset's file
lists, infinite_indices, ShardLoader's batches (native and numpy), the
native reader's build into build/runtime/ and its failures, and the
image-mode dataset."""
import filecmp
import json
import os
import shutil

import numpy as np
import pytest

from efficient_nerf_tpu_torch.core.poses import pose_spherical
from efficient_nerf_tpu_torch.core.rays import get_rays_np, pixel_dirs
from efficient_nerf_tpu_torch.data import (ImageFrameDataset, RayShardDataset,
                                           ShardLoader, append_pseudo_frames,
                                           infinite_indices, make_forward_facing_scene,
                                           make_synthetic_scene, pseudo_ratio_schedule,
                                           rays_to_shards, render_sphere_frame,
                                           setup_image_datadir)
from efficient_nerf_tpu_torch.data import native
from efficient_nerf_tpu_torch.data.convert import _pack_image_rays

CAMERAS = [(12, 16, 20.0, pose_spherical(30.0, -30.0, 4.0)),
           (9, 7, 11.5, pose_spherical(-120.0, -60.0, 3.5)),
           (10, 12, 14.0, np.concatenate([np.eye(3, dtype=np.float32),
                                          np.float32([[0.1], [0.2], [0.3]])], 1))]


@pytest.mark.parametrize("cam", range(len(CAMERAS)))
def test_get_rays_np_is_bitwise_jax(cam):
    from efficient_nerf_tpu.core import rays as jrays

    H, W, focal, c2w = CAMERAS[cam]
    o, d = get_rays_np(H, W, focal, c2w)
    jo, jd = jrays.get_rays_np(H, W, focal, c2w)
    assert o.shape == d.shape == (H, W, 3)
    np.testing.assert_array_equal(o, jo)
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(pixel_dirs(H, W, focal, device="cpu").numpy(),
                                  np.asarray(jrays.pixel_dirs(H, W, focal)))


@pytest.mark.parametrize("kw", [dict(), dict(radius=0.9, center=(0.2, -0.1, 0.3))])
def test_render_sphere_frame_is_bitwise_jax(kw):
    from efficient_nerf_tpu.data import synthetic as jsyn

    for H, W, focal, c2w in CAMERAS[:2]:
        got = render_sphere_frame(c2w, H, W, focal, **kw)
        want = jsyn.render_sphere_frame(c2w, H, W, focal, **kw)
        assert got.shape == (H, W, 4) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        assert 0 < got[..., 3].sum() < H * W   # the sphere and the background


def _same_tree(a, b):
    """Every file under a equals the file of the same name under b: a PNG
    in its pixels (the port writes its PNGs with its own encoder, so the
    compressed bytes differ from imageio's; imageio decodes both), every
    other file byte for byte."""
    names = sorted(os.path.relpath(os.path.join(r, f), a)
                   for r, _, fs in os.walk(a) for f in fs)
    assert names == sorted(os.path.relpath(os.path.join(r, f), b)
                           for r, _, fs in os.walk(b) for f in fs)
    for n in names:
        if n.endswith(".png"):
            import imageio.v2 as imageio

            np.testing.assert_array_equal(imageio.imread(os.path.join(a, n)),
                                          imageio.imread(os.path.join(b, n)), n)
        else:
            assert filecmp.cmp(os.path.join(a, n), os.path.join(b, n), shallow=False), n
    return names


def test_scene_writers_write_the_jax_files(tmp_path):
    from efficient_nerf_tpu.data import synthetic as jsyn

    hwf = make_synthetic_scene(str(tmp_path / "p"), n_train=3, n_val=1, n_test=2, H=12, W=12)
    assert hwf == jsyn.make_synthetic_scene(str(tmp_path / "j"), n_train=3, n_val=1,
                                            n_test=2, H=12, W=12)
    assert len(_same_tree(str(tmp_path / "p"), str(tmp_path / "j"))) == 9
    hwf = make_forward_facing_scene(str(tmp_path / "pf"), n_images=3, H=8, W=10)
    assert hwf == jsyn.make_forward_facing_scene(str(tmp_path / "jf"), n_images=3, H=8, W=10)
    assert len(_same_tree(str(tmp_path / "pf"), str(tmp_path / "jf"))) == 4


def _frame_rows(n_frames=3, H=40, W=36, focal=30.0):
    rows = []
    for i in range(n_frames):
        pose = pose_spherical(-150.0 + 100.0 * i, -30.0, 4.0)
        img = render_sphere_frame(pose, H, W, focal)
        rgb = img[..., :3] * img[..., 3:] + (1.0 - img[..., 3:])
        rows.append(_pack_image_rays(H, W, focal, pose[:3, :4], rgb))
    return np.concatenate(rows)


def test_pack_image_rays_matches_jax():
    from efficient_nerf_tpu.data import convert as jconv

    H, W, focal, c2w = CAMERAS[2]
    img = np.random.default_rng(1).uniform(size=(H, W, 3)).astype(np.float32)
    np.testing.assert_array_equal(_pack_image_rays(H, W, focal, c2w, img),
                                  jconv._pack_image_rays(H, W, focal, c2w, img))
    # ndc: the projection in torch and in jnp, the same f32 operations in
    # the same order (the port's ndc_rays divides where JAX does)
    np.testing.assert_allclose(_pack_image_rays(H, W, focal, c2w, img, ndc=True),
                               jconv._pack_image_rays(H, W, focal, c2w, img, ndc=True),
                               rtol=1e-6, atol=1e-6)


def test_rays_to_shards_writes_the_jax_files(tmp_path):
    from efficient_nerf_tpu.data import convert as jconv

    rows = _frame_rows()
    n = rays_to_shards(rows, str(tmp_path / "p"), rng=np.random.default_rng(3))
    assert n == jconv.rays_to_shards(rows, str(tmp_path / "j"), rng=np.random.default_rng(3))
    assert n == rows.shape[0] // 4096 and n > 0
    names = _same_tree(str(tmp_path / "p"), str(tmp_path / "j"))
    assert names == sorted(f"train_{k + 1}.npy" for k in range(n))


@pytest.fixture
def shard_dir(tmp_path):
    """7 real shards (train_*) and 9 pseudo shards (data_*) of [4096, 9]."""
    rng = np.random.default_rng(0)
    out = str(tmp_path / "shards")
    rays_to_shards(rng.normal(size=(4096 * 7, 9)).astype(np.float32), out)
    rays_to_shards(rng.normal(size=(4096 * 9, 9)).astype(np.float32), out, prefix="data_")
    return out


@pytest.mark.parametrize("kw", [dict(), dict(pseudo_ratio=0.5), dict(pseudo_ratio=0.8),
                                dict(hold_ratio=0.3), dict(pseudo_ratio=0.5, hold_ratio=0.2)])
def test_ray_shard_dataset_picks_the_jax_files(shard_dir, kw):
    from efficient_nerf_tpu.data import rays_dataset as jrd

    ds = RayShardDataset(shard_dir, rng=np.random.default_rng(5), **kw)
    jds = jrd.RayShardDataset(shard_dir, rng=np.random.default_rng(5), **kw)
    assert ds.files == [str(f) for f in jds.files]
    assert (ds.n_pseudo, ds.n_original) == (jds.n_pseudo, jds.n_original) == (9, 7)
    d = ds.load(0)
    for a, b in zip(ds.split_columns(d), jds.split_columns(d)):
        np.testing.assert_array_equal(a, b)
    for bad in (dict(pseudo_ratio=1.5), dict(hold_ratio=1.0)):
        with pytest.raises(ValueError):
            RayShardDataset(shard_dir, **bad)


def test_infinite_indices_match_jax():
    from efficient_nerf_tpu.data import rays_dataset as jrd

    a = infinite_indices(7, np.random.default_rng(2))
    b = jrd.infinite_indices(7, np.random.default_rng(2))
    got = [next(a) for _ in range(30)]
    assert got == [next(b) for _ in range(30)]
    assert sorted(got[:7]) == list(range(7))


@pytest.mark.parametrize("use_native", [True, False])
def test_shard_loader_yields_the_jax_batches(shard_dir, use_native):
    """One worker thread: the batches follow the rng alone. The JAX loader
    runs its numpy path (its native path would build the JAX package's own
    library into runtime/)."""
    from efficient_nerf_tpu.data import rays_dataset as jrd

    ds = RayShardDataset(shard_dir, rng=np.random.default_rng(1))
    jds = jrd.RayShardDataset(shard_dir, rng=np.random.default_rng(1))
    loader = ShardLoader(ds, 3, rng=np.random.default_rng(4), num_threads=1,
                         use_native=use_native)
    jloader = jrd.ShardLoader(jds, 3, rng=np.random.default_rng(4), num_threads=1,
                              use_native=False)
    try:
        assert (loader._native is not None) == use_native
        for _ in range(8):       # more than a pass over the 16 shards
            got, want = next(loader), next(jloader)
            for a, b in zip(got, want):
                assert a.shape == (3 * 4096, 3) and a.dtype == np.float32
                np.testing.assert_array_equal(a, b)
    finally:
        loader.close()
        jloader.close()
    assert not any(t.is_alive() for t in loader._threads)


def test_native_reader_builds_into_build_runtime(shard_dir):
    ds = RayShardDataset(shard_dir)
    path = native.build_library()
    assert path.parent == native.BUILD_DIR and path.parent.parts[-2:] == ("build", "runtime")
    assert path.exists() and path == native.library_path()
    reader = native.NativeShardReader(ds.files, rows=4096, cols=9)
    try:
        got = reader.load_batch([0, 5, 2])
        np.testing.assert_array_equal(
            got, np.concatenate([np.load(ds.files[i]) for i in (0, 5, 2)]))
        with pytest.raises(IOError):
            reader.load_batch([len(ds.files)])
        with pytest.raises(ValueError):
            reader.load_batch([0], out=np.empty((10, 9), np.float32))
    finally:
        reader.close()


def test_native_reader_build_failures_raise(tmp_path, shard_dir, monkeypatch):
    """On a copy of the source, never runtime/ itself: a missing source and a
    source g++ rejects raise; so does a loader asked for the native reader
    when it cannot be had."""
    src = tmp_path / "shard_reader.cpp"
    shutil.copy(native.RUNTIME_SRC, src)
    built = native.build_library(src, tmp_path / "build")
    assert built.parent == tmp_path / "build" and built.exists()
    src.write_text(src.read_text() + "\nthis is not C++;\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build_library(src, tmp_path / "build")
    src.unlink()
    with pytest.raises(RuntimeError, match="missing"):
        native.load_library(src, tmp_path / "build")
    monkeypatch.setattr(native, "RUNTIME_SRC", src)
    with pytest.raises(RuntimeError, match="missing"):
        ShardLoader(RayShardDataset(shard_dir), 2, use_native=True)


def test_shard_loader_raises_a_worker_error(shard_dir):
    ds = RayShardDataset(shard_dir, rng=np.random.default_rng(0))
    loader = ShardLoader(ds, 16, num_threads=1, use_native=False)
    try:
        next(loader)
        for f in ds.files:
            os.remove(f)
        with pytest.raises(RuntimeError, match="worker failed"):
            for _ in range(4):   # past the batches already prefetched
                next(loader)
    finally:
        loader.close()


@pytest.fixture
def image_dir(tmp_path):
    """A .npy image-mode data dir: 4 original frames."""
    d = tmp_path / "kd"
    os.makedirs(d / "train")
    frames = []
    for i in range(4):
        rel = f"./train/r_{i}"
        np.save(d / f"{rel}.npy", np.full((4, 5, 3), i / 4, np.float32))
        frames.append({"file_path": rel,
                       "transform_matrix": pose_spherical(40.0 * i, -30.0, 4.0).tolist()})
    with open(d / "transforms_train.json", "w") as f:
        json.dump({"camera_angle_x": 0.69, "frames": frames}, f)
    return str(d)


def test_image_frame_dataset_and_pseudo_frames_match_jax(image_dir, tmp_path):
    from efficient_nerf_tpu.data import images_dataset as jid

    jdir = str(tmp_path / "kd_jax")
    shutil.copytree(image_dir, jdir)
    rng = np.random.default_rng(0)
    poses = [pose_spherical(float(t), -20.0, 4.0) for t in rng.uniform(-180, 180, 5)]
    imgs = [rng.uniform(size=(4, 5, 3)).astype(np.float32) for _ in poses]
    append_pseudo_frames(image_dir, poses, imgs)
    jid.append_pseudo_frames(jdir, poses, imgs)
    _same_tree(image_dir, jdir)
    for ratio in (0.0, 0.5, 0.75):
        ds = ImageFrameDataset(image_dir, pseudo_ratio=ratio, n_original=3,
                               rng=np.random.default_rng(7))
        jds = jid.ImageFrameDataset(jdir, pseudo_ratio=ratio, n_original=3,
                                    rng=np.random.default_rng(7))
        assert ds.frames == jds.frames and len(ds) == len(jds)
        for i in range(len(ds) + 2):
            for a, b in zip(ds[i], jds[i]):
                np.testing.assert_array_equal(a, b)


def test_pseudo_ratio_schedule_matches_jax():
    from efficient_nerf_tpu.data import images_dataset as jid

    for step in (0, 1, 2, 1000, 250_000, 499_999, 500_000, 600_000):
        assert pseudo_ratio_schedule("1:0.2,500000:0.9", step) == \
            jid.pseudo_ratio_schedule("1:0.2,500000:0.9", step)


def test_setup_image_datadir_matches_jax(blender_dir, tmp_path):
    from efficient_nerf_tpu.data import images_dataset as jid

    for half in (False, True):
        setup_image_datadir(blender_dir, str(tmp_path / "p"), half_res=half)
        jid.setup_image_datadir(blender_dir, str(tmp_path / "j"), half_res=half)
        assert len(_same_tree(str(tmp_path / "p"), str(tmp_path / "j"))) == 4
