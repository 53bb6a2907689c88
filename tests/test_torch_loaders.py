"""The port's scene loaders, converters and pose paths against the JAX
package's, on small scenes that the tests write: the pose functions bit for
bit, the blender (NeRF and DONeRF layouts), LLFF and DeepVoxels loaders'
arrays, and the converters' shards byte for byte for the same seed.

Each loader gets its own copy of a scene: `minify` caches images_{factor}/
inside the scene directory, so a shared one would let the second loader
read the first one's output."""
import filecmp
import json
import os
import shutil

import numpy as np
import pytest

imageio = pytest.importorskip("imageio.v2")
pytest.importorskip("cv2")

from efficient_nerf_tpu.core import poses as jposes  # noqa: E402
from efficient_nerf_tpu.data import blender as jblender  # noqa: E402
from efficient_nerf_tpu.data import deepvoxels as jdv  # noqa: E402
from efficient_nerf_tpu.data import llff as jllff  # noqa: E402
from efficient_nerf_tpu_torch.core import poses  # noqa: E402
from efficient_nerf_tpu_torch.data import (FICUS_IGNORE, composite_white,  # noqa: E402
                                           convert_blender_to_rays, convert_llff_to_rays,
                                           donerf_ray_directions, load_blender_data,
                                           load_dv_data, load_llff_data,
                                           make_forward_facing_scene,
                                           make_synthetic_scene, minify)


def _assert_same(got, want):
    """Two loader results (NamedTuples of arrays, tuples and numbers), field
    for field and bit for bit."""
    assert type(got).__name__ == type(want).__name__
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        if isinstance(w, tuple):
            assert len(g) == len(w), name
            for a, b in zip(g, w):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)
        else:
            g, w = np.asarray(g), np.asarray(w)
            assert g.dtype == w.dtype, name
            # assert_array_equal takes NaN for NaN: the arrays must be finite
            assert np.isfinite(g).all(), name
            np.testing.assert_array_equal(g, w, err_msg=name)


def _twin(tmp_path, write, name):
    """The scene that `write(dir)` writes, twice: (port's copy, JAX's copy)."""
    a, b = str(tmp_path / f"{name}_port"), str(tmp_path / f"{name}_jax")
    write(a)
    shutil.copytree(a, b)
    return a, b


def _same_tree(a, b):
    """Every file under a equals, byte for byte, the file of the same name
    under b; returns the names."""
    names = sorted(os.path.relpath(os.path.join(r, f), a)
                   for r, _, fs in os.walk(a) for f in fs)
    assert names == sorted(os.path.relpath(os.path.join(r, f), b)
                           for r, _, fs in os.walk(b) for f in fs)
    for n in names:
        assert filecmp.cmp(os.path.join(a, n), os.path.join(b, n), shallow=False), n
    return names


# ---- pose paths: the same numpy code, bit for bit

@pytest.mark.parametrize("n_pose,phi,radius", [(40, -30.0, 4.0), (7, -60.0, 3.2)])
def test_spherical_render_poses_bitwise(n_pose, phi, radius):
    got = poses.spherical_render_poses(n_pose, phi, radius)
    np.testing.assert_array_equal(got, jposes.spherical_render_poses(n_pose, phi, radius))
    assert got.shape == (n_pose, 4, 4) and got.dtype == np.float32


@pytest.mark.parametrize("spec", [5, ["sample:3", "fix:-45", 2],
                                  [4, 2, "fix:3.5"], ["fix:10", "sample:2", "sample:3"],
                                  [np.int64(3), "-20", "4.0"]])
def test_novel_pose_grid_bitwise(spec):
    got = poses.novel_pose_grid(spec)
    np.testing.assert_array_equal(got, jposes.novel_pose_grid(spec))
    for axis in (spec if isinstance(spec, list) else []):
        for trim in ("theta", "interior"):
            np.testing.assert_array_equal(poses._axis_values(axis, -90.0, 0.0, trim),
                                          jposes._axis_values(axis, -90.0, 0.0, trim))


def _capture(rng, n=9, spread=0.5):
    """[n, 3, 5] poses of cameras on a cap of the unit sphere looking at the
    origin (orientations differ, so that spherify's least-squares centre is
    defined), with an hwf column, and their [n, 2] bounds."""
    out = []
    for _ in range(n):
        th, ph = rng.uniform(-spread, spread), rng.uniform(-spread, spread)
        c = np.array([np.sin(th), np.sin(ph), np.cos(th) * np.cos(ph)]) * 4.0
        out.append(np.concatenate([poses.viewmatrix(c, np.array([0, 1.0, 0]), c),
                                   np.array([[24.0], [32.0], [30.0]])], 1))
    bds = np.stack([rng.uniform(2.0, 2.5, n), rng.uniform(5.0, 6.0, n)], 1)
    return np.stack(out).astype(np.float32), bds.astype(np.float32)


def test_llff_pose_pipeline_bitwise(rng):
    p, bds = _capture(rng)
    np.testing.assert_array_equal(poses.recenter_poses(p), jposes.recenter_poses(p))
    c2w = poses.poses_avg(p)
    up = poses.normalize(p[:, :3, 1].sum(0))
    for zrate, rots, n in ((0.5, 2, 120), (0.0, 1, 7)):
        got = poses.render_path_spiral(c2w, up, [0.3, 0.2, 0.1], 4.2, zrate, rots, n)
        np.testing.assert_array_equal(
            got, jposes.render_path_spiral(c2w, up, [0.3, 0.2, 0.1], 4.2, zrate, rots, n))
        assert got.shape == (n, 3, 5)
    got = poses.spherify_poses(p, bds)
    want = jposes.spherify_poses(p, bds)
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        np.testing.assert_array_equal(g, w)
    assert got[1].shape == (120, 3, 5)


# ---- blender and DONeRF

def _blender(outdir, donerf=False, H=16, n_train=4):
    make_synthetic_scene(outdir, n_train=n_train, n_val=2, n_test=3, H=H, W=H, seed=1)
    if donerf:
        # DONeRF keeps camera_angle_x in dataset_info.json, not the transforms
        for split in ("train", "val", "test"):
            path = os.path.join(outdir, f"transforms_{split}.json")
            with open(path) as f:
                meta = json.load(f)
            cax = meta.pop("camera_angle_x")
            with open(path, "w") as f:
                json.dump(meta, f)
        with open(os.path.join(outdir, "dataset_info.json"), "w") as f:
            json.dump({"camera_angle_x": cax * 1.25}, f)


@pytest.mark.parametrize("kw", [dict(), dict(half_res=True, testskip=2),
                                dict(testskip=0, n_pose=6, splits=("train", "test")),
                                dict(random_render_poses=5)])
@pytest.mark.parametrize("donerf", [False, True])
def test_load_blender_data_matches_jax(tmp_path, donerf, kw):
    a, b = _twin(tmp_path, lambda d: _blender(d, donerf), "blender")
    got = load_blender_data(a, **kw, rng=np.random.default_rng(4)) \
        if kw.get("random_render_poses") else load_blender_data(a, **kw)
    want = jblender.load_blender_data(b, **kw, rng=np.random.default_rng(4)) \
        if kw.get("random_render_poses") else jblender.load_blender_data(b, **kw)
    _assert_same(got, want)
    H = 8 if kw.get("half_res") else 16
    assert got.images.shape[1:] == (H, H, 4) and got.hwf[:2] == (H, H)
    for white in (False, True):
        np.testing.assert_array_equal(composite_white(got.images, white),
                                      jblender.composite_white(want.images, white))


# ---- LLFF

def _llff_spherical(outdir, rng, n=9, H=24, W=32):
    """An LLFF scene of a capture round the origin (see _capture), random
    images, poses stored in LLFF's [down, right, back] column order."""
    p, bds = _capture(rng, n)
    os.makedirs(os.path.join(outdir, "images"))
    rows = []
    for i in range(n):
        img = (rng.uniform(size=(H, W, 3)) * 255).astype(np.uint8)
        imageio.imwrite(os.path.join(outdir, "images", f"img_{i:03d}.png"), img)
        c = p[i]
        stored = np.stack([-c[:, 1], c[:, 0], c[:, 2], c[:, 3], c[:, 4]], 1)
        rows.append(np.concatenate([stored.reshape(-1), bds[i]]))
    np.save(os.path.join(outdir, "poses_bounds.npy"), np.stack(rows).astype(np.float64))


@pytest.mark.parametrize("kw", [dict(factor=1), dict(factor=2),
                                dict(factor=1, path_zflat=True),
                                dict(factor=2, recenter=False, bd_factor=None,
                                     n_pose_video=10)])
def test_load_llff_data_matches_jax(tmp_path, kw):
    a, b = _twin(tmp_path, lambda d: make_forward_facing_scene(d, n_images=6, H=24, W=32),
                 "llff")
    got, want = load_llff_data(a, **kw), jllff.load_llff_data(b, **kw)
    _assert_same(got, want)
    f = kw["factor"]
    assert got.images.shape == (6, 24 // f, 32 // f, 3)
    assert got.render_poses.shape[0] == kw.get("n_pose_video", 120) // (
        2 if kw.get("path_zflat") else 1)
    if f > 1:   # each loader minified its own copy
        _same_tree(os.path.join(a, f"images_{f}"), os.path.join(b, f"images_{f}"))


@pytest.mark.parametrize("factor", [1, 2])
def test_load_llff_data_spherify_matches_jax(tmp_path, factor):
    a, b = _twin(tmp_path, lambda d: _llff_spherical(d, np.random.default_rng(2)),
                 "sph")
    got = load_llff_data(a, factor=factor, spherify=True)
    want = jllff.load_llff_data(b, factor=factor, spherify=True)
    _assert_same(got, want)
    assert got.render_poses.shape == (120, 3, 5)


def test_minify_reuses_its_cache(tmp_path):
    d = str(tmp_path / "llff")
    make_forward_facing_scene(d, n_images=3, H=24, W=32)
    out = minify(d, 4)
    assert out == os.path.join(d, "images_4")
    first = os.path.join(out, "img_000.png")
    assert imageio.imread(first).shape == (6, 8, 3)
    stamp = os.stat(first).st_mtime_ns
    os.utime(first, ns=(stamp - 10**9, stamp - 10**9))
    # a full cache is read as it is, by either package
    assert minify(d, 4) == jllff.minify(d, 4) == out
    assert os.stat(first).st_mtime_ns == stamp - 10**9
    # an incomplete one is written again
    os.remove(os.path.join(out, "img_002.png"))
    minify(d, 4)
    assert os.stat(first).st_mtime_ns != stamp - 10**9
    assert len(os.listdir(out)) == 3


# ---- DeepVoxels

def _deepvoxels(basedir, scene="cube", rng=None, n=(3, 4, 5)):
    """{split}/{scene}/ with intrinsics.txt, pose/*.txt (4x4 c2w) and
    rgb/*.png for the train, validation and test splits."""
    rng = rng or np.random.default_rng(7)
    for split, k in zip(("train", "validation", "test"), n):
        base = os.path.join(basedir, split, scene)
        os.makedirs(os.path.join(base, "pose"))
        os.makedirs(os.path.join(base, "rgb"))
        with open(os.path.join(base, "intrinsics.txt"), "w") as f:
            f.write("480.5 256.0 256.0 0.\n0. 0. 0.\n0.8\n1.\n512 512\n")
        for i in range(k):
            c2w = np.eye(4)
            c2w[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
            c2w[:3, 3] = rng.normal(size=3)
            with open(os.path.join(base, "pose", f"{i:05d}.txt"), "w") as f:
                f.write(" ".join(f"{v:.9f}" for v in c2w.reshape(-1)))
            img = (rng.uniform(size=(8, 8, 3)) * 255).astype(np.uint8)
            imageio.imwrite(os.path.join(base, "rgb", f"{i:05d}.png"), img)


@pytest.mark.parametrize("testskip", [1, 2])
def test_load_dv_data_matches_jax(tmp_path, testskip):
    a, b = _twin(tmp_path, _deepvoxels, "dv")
    got = load_dv_data("cube", a, testskip=testskip)
    want = jdv.load_dv_data("cube", b, testskip=testskip)
    _assert_same(got, want)
    H, W, focal = got.hwf
    assert (H, W) == (512, 512) and focal == 480.5
    assert got.images.shape[0] == 3 + -(-4 // testskip) + -(-5 // testskip)
    # the stored poses' y and z columns flipped to the NeRF convention
    raw = np.loadtxt(os.path.join(a, "train", "cube", "pose", "00000.txt")).reshape(4, 4)
    np.testing.assert_allclose(got.poses[0], (raw @ np.diag([1, -1, -1, 1.0]))[:3],
                               rtol=0, atol=1e-7)


# ---- converters: the same shards, byte for byte, for the same seed

def test_donerf_ray_directions_bitwise():
    from efficient_nerf_tpu.data import convert as jconv

    for H, W, cax, focal in ((6, 8, 0.69, 11.0), (9, 9, 1.2, 4.5)):
        got = donerf_ray_directions(H, W, cax, focal)
        np.testing.assert_array_equal(got, jconv.donerf_ray_directions(H, W, cax, focal))
        np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-6)
    assert FICUS_IGNORE == jconv.FICUS_IGNORE


@pytest.mark.parametrize("kw", [dict(), dict(ignore="1,4,6"), dict(donerf=True),
                                dict(donerf=True, half_res=False, white_bkgd=False,
                                     seed=3)])
def test_convert_blender_to_rays_matches_jax(tmp_path, kw):
    from efficient_nerf_tpu.data import convert as jconv

    # 9 training frames of 32 x 32 after half_res: two shards, or one with
    # three frames ignored
    a, b = _twin(tmp_path, lambda d: _blender(d, kw.get("donerf", False), H=64,
                                              n_train=9), "blend")
    out_a, out_b = str(tmp_path / "shards_port"), str(tmp_path / "shards_jax")
    n = convert_blender_to_rays(a, out_a, **kw)
    assert n == jconv.convert_blender_to_rays(b, out_b, **kw) and n >= 1
    assert _same_tree(out_a, out_b) == sorted(f"train_{k + 1}.npy" for k in range(n))


@pytest.mark.parametrize("ndc", [False, True])
@pytest.mark.parametrize("factor,llffhold", [(1, 8), (2, 0)])
def test_convert_llff_to_rays_matches_jax(tmp_path, ndc, factor, llffhold):
    from efficient_nerf_tpu.data import convert as jconv

    a, b = _twin(tmp_path, lambda d: make_forward_facing_scene(d, n_images=8, H=48, W=64),
                 "llffc")
    out_a, out_b = str(tmp_path / "shards_port"), str(tmp_path / "shards_jax")
    n = convert_llff_to_rays(a, out_a, factor=factor, llffhold=llffhold, ndc=ndc)
    assert n == jconv.convert_llff_to_rays(b, out_b, factor=factor, llffhold=llffhold,
                                           ndc=ndc) and n >= 1
    assert _same_tree(out_a, out_b) == sorted(f"train_{k + 1}.npy" for k in range(n))


def test_convert_llff_to_rays_defaults_to_raw_rays(tmp_path):
    from efficient_nerf_tpu.data import convert as jconv

    a, b = _twin(tmp_path, lambda d: make_forward_facing_scene(d, n_images=8, H=48, W=64),
                 "llffd")
    out_a, out_b = str(tmp_path / "shards_port"), str(tmp_path / "shards_jax")
    convert_llff_to_rays(a, out_a, factor=1)
    jconv.convert_llff_to_rays(b, out_b, factor=1, ndc=False)
    _same_tree(out_a, out_b)
    # raw world rays: the origins are the cameras', not on NDC's near plane
    rows = np.load(os.path.join(out_a, "train_1.npy"))
    assert not np.allclose(rows[:, 2], -1.0)
