"""The port's reader of the reference's own `.tar` files against the JAX
package's: an R2L file with the whole module pickled under `network_fn`
(zip and legacy formats) and a teacher file with `network_fine_state_dict`
give both packages the same step and outputs, through the port's
--pretrained_ckpt. A pickled global outside the reader's allowlist is
neither imported nor called. And `convert_torch_lpips` of both packages
writes the same `.npz` from one stand-in `lpips` module."""
import builtins
import importlib
import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_nerf_tpu.metrics.lpips import convert_torch_lpips as jax_convert
from efficient_nerf_tpu.models import NeRFMLP as JaxNeRFMLP
from efficient_nerf_tpu.models import R2LNet as JaxR2LNet
from efficient_nerf_tpu.train import import_reference_checkpoint as jax_import
from efficient_nerf_tpu_torch import factory
from efficient_nerf_tpu_torch.config.options import parse_args
from efficient_nerf_tpu_torch.metrics.lpips import convert_torch_lpips, lpips
from efficient_nerf_tpu_torch.models.torch_import import StubbedGlobal, load_torch_checkpoint
from efficient_nerf_tpu_torch.train import import_reference_checkpoint

sys.path.insert(0, os.path.dirname(__file__))
from test_models import TorchNeRF, TorchR2L  # noqa: E402

STUDENT = ["--model_name", "R2L", "--trial.ON", "--trial.body_arch", "resmlp",
           "--netdepth", "6", "--netwidth", "16", "--n_sample_per_ray", "4",
           "--multires", "3", "--use_residual"]
TEACHER = ["--model_name", "nerf", "--use_viewdirs", "--netdepth", "3", "--netwidth", "16",
           "--netdepth_fine", "3", "--netwidth_fine", "16", "--multires", "4",
           "--multires_views", "2", "--skips", "1", "--N_importance", "4"]
IN_DIM = 3 * 4 * (2 * 3 + 1)        # the student's embed: 4 points, L 3
# f32 on all sides: the same products summed in another order
OUT_TOL = 1e-5
FORMATS = {"zip": True, "legacy": False}


def _bundle(argv):
    return factory.create_models(parse_args(["--dataset_type", "blender"] + argv), 2.0, 6.0,
                                 device="cpu")


def _save(obj, path, fmt):
    torch.save(obj, path, _use_new_zipfile_serialization=FORMATS[fmt])
    return path


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_reference_r2l_tar_with_its_pickled_module(fmt, tmp_path, rng):
    torch.manual_seed(0)
    tm = TorchR2L(input_dim=IN_DIM, D=6, W=16, n_block=2, use_residual=True)
    path = _save({"global_step": 77, "best_psnr": 30.0,
                  "network_fn_state_dict": tm.state_dict(),
                  "network_fn": tm}, str(tmp_path / "ref.tar"), fmt)
    x = rng.normal(size=(9, IN_DIM)).astype(np.float32)
    jmeta, params = jax_import(path, "r2l", n_block=2)
    want = np.asarray(JaxR2LNet(input_dim=IN_DIM, depth=6, width=16, use_residual=True)
                      .apply({"params": params}, jnp.asarray(x)))
    b = _bundle(STUDENT + ["--pretrained_ckpt", path, "--resume"])
    assert b.history["start"] == jmeta["step"] == 77
    assert b.history["best_psnr"] == jmeta["best_psnr"] == 30.0
    with torch.no_grad():
        got = b.model(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, tm(torch.from_numpy(x)).numpy(), atol=OUT_TOL, rtol=0)
    np.testing.assert_allclose(got, want, atol=OUT_TOL, rtol=0)
    # the module entry is an inert stub that kept its state
    ckpt = load_torch_checkpoint(path)
    assert isinstance(ckpt["network_fn"], StubbedGlobal)
    assert type(ckpt["network_fn"]).__name__ == "TorchR2L"
    assert "_parameters" in ckpt["network_fn"]._state


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_reference_teacher_tar_with_a_fine_network(fmt, tmp_path, rng):
    torch.manual_seed(1)
    nets = {k: TorchNeRF(D=3, W=16, input_ch=27, input_ch_views=15, skips=(1,))
            for k in ("fn", "fine")}
    path = _save({"global_step": 12, **{f"network_{k}_state_dict": n.state_dict()
                                        for k, n in nets.items()}},
                 str(tmp_path / "teacher.tar"), fmt)
    x = rng.normal(size=(9, 42)).astype(np.float32)
    jmeta, params = jax_import(path, "nerf", depth=3, use_viewdirs=True)
    jm = JaxNeRFMLP(depth=3, width=16, input_ch=27, input_ch_views=15, skips=(1,),
                    output_ch=5)
    b = _bundle(TEACHER + ["--pretrained_ckpt", path])
    meta = import_reference_checkpoint(path, b.model)
    assert meta["step"] == jmeta["step"] == 12 and meta["optimizer_state_dict"] is None
    for ours, theirs in (("coarse", "fn"), ("fine", "fine")):
        with torch.no_grad():
            got = b.model[ours](torch.from_numpy(x)).numpy()
            np.testing.assert_allclose(got, nets[theirs](torch.from_numpy(x)).numpy(),
                                       atol=OUT_TOL, rtol=0)
        want = np.asarray(jm.apply({"params": params[ours]}, jnp.asarray(x)))
        np.testing.assert_allclose(got, want, atol=OUT_TOL, rtol=0)


def test_reference_optimizer_state_restores(tmp_path, rng):
    torch.manual_seed(2)
    tm = TorchR2L(input_dim=IN_DIM, D=6, W=16, n_block=2, use_residual=True)
    opt = torch.optim.Adam(tm.parameters(), lr=5e-4)
    tm(torch.from_numpy(rng.normal(size=(8, IN_DIM)).astype(np.float32))).sum().backward()
    opt.step()
    path = _save({"global_step": 1, "network_fn_state_dict": tm.state_dict(),
                  "network_fn": tm, "optimizer_state_dict": opt.state_dict()},
                 str(tmp_path / "ref.tar"), "zip")
    b = _bundle(STUDENT + ["--pretrained_ckpt", path, "--resume"])
    b.optimizer.load_state_dict(b.restored_opt_state)
    for i, s in opt.state_dict()["state"].items():
        got = b.optimizer.state_dict()["state"][i]
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(got[k], s[k]), (i, k)


def test_python2_builtins_are_the_real_ones(tmp_path):
    # torch.save's protocol 2 names __builtin__.set; the reader maps it
    # to builtins.set before its allowlist
    path = _save({"tags": {1, 2}, "pair": (1.5, "a"), "n": [3]}, str(tmp_path / "b.tar"), "zip")
    ckpt = load_torch_checkpoint(path)
    assert ckpt == {"tags": {1, 2}, "pair": (1.5, "a"), "n": [3]}
    assert type(ckpt["tags"]) is set


SIDE = "efficient_nerf_side_effect_target"


def test_a_pickled_global_is_neither_imported_nor_run(tmp_path, monkeypatch):
    # a class of a module that exists only while saving, as a reference
    # file's model class does; on disk the module sets a sentinel on import
    mods = tmp_path / "mods"
    mods.mkdir()
    (mods / f"{SIDE}.py").write_text(
        "import os\nos.environ['EFFICIENT_NERF_SENTINEL'] = 'imported'\n"
        "class Model:\n    pass\n")
    fake = types.ModuleType(SIDE)
    fake.Model = type("Model", (), {"__module__": SIDE, "__qualname__": "Model"})
    monkeypatch.setitem(sys.modules, SIDE, fake)
    obj = fake.Model()
    obj.weights = torch.ones(2)
    path = _save({"global_step": 3, "network_fn_state_dict": {"w": torch.zeros(2)},
                  "network_fn": obj}, str(tmp_path / "side.tar"), "zip")
    monkeypatch.delitem(sys.modules, SIDE)
    monkeypatch.syspath_prepend(str(mods))
    monkeypatch.setenv("EFFICIENT_NERF_SENTINEL", "unset")
    load_torch_checkpoint(path)                 # the reader's own lazy imports
    before = set(sys.modules)
    ckpt = load_torch_checkpoint(path)
    assert os.environ["EFFICIENT_NERF_SENTINEL"] == "unset"
    assert set(sys.modules) == before and SIDE not in sys.modules
    stub = ckpt["network_fn"]
    assert isinstance(stub, StubbedGlobal) and type(stub).__module__ == SIDE
    assert torch.equal(stub._state["weights"], torch.ones(2))
    # the control: importing the module does run it
    importlib.import_module(SIDE)
    assert os.environ["EFFICIENT_NERF_SENTINEL"] == "imported"
    monkeypatch.delitem(sys.modules, SIDE)


class _Calls:
    """Pickles as a call of fn(*args)."""

    def __init__(self, fn, args):
        self.fn, self.args = fn, args

    def __reduce__(self):
        return self.fn, self.args


@pytest.mark.parametrize("fn", ["os.system", "builtins.exec", "os.mkdir"])
def test_a_pickled_callable_is_never_called(fn, tmp_path):
    marker = str(tmp_path / "called")
    fn, args = {"os.system": (os.system, (f"touch {marker}",)),
                "builtins.exec": (builtins.exec, (f"open({marker!r}, 'w').close()",)),
                "os.mkdir": (os.mkdir, (marker,))}[fn]
    path = _save({"global_step": 1, "network_fn": _Calls(fn, args)},
                 str(tmp_path / "call.tar"), "zip")
    ckpt = load_torch_checkpoint(path)
    assert not os.path.exists(marker)
    stub = ckpt["network_fn"]
    assert isinstance(stub, StubbedGlobal) and type(stub).__name__ == fn.__name__
    assert stub._args == args
    with pytest.raises(RuntimeError, match="stub"):
        stub()


def _lpips_stand_in(rng):
    """A module named lpips whose LPIPS(net="alex") has the pip package's
    AlexNet-LPIPS state_dict keys and shapes, random values."""
    shapes = {f"net.slice{i + 1}.{ti}": (o, c, k, k) for i, (ti, o, c, k) in enumerate(
        [(0, 64, 3, 11), (3, 192, 64, 5), (6, 384, 192, 3), (8, 256, 384, 3),
         (10, 256, 256, 3)])}
    sd = {}
    for name, shape in shapes.items():
        sd[f"{name}.weight"] = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        sd[f"{name}.bias"] = torch.from_numpy(rng.normal(size=shape[0]).astype(np.float32))
    for i, c in enumerate((64, 192, 384, 256, 256)):
        sd[f"lin{i}.model.1.weight"] = torch.from_numpy(
            rng.uniform(size=(1, c, 1, 1)).astype(np.float32))
    sd["scaling_layer.shift"] = torch.tensor([-0.030, -0.088, -0.188]).reshape(1, 3, 1, 1)
    sd["scaling_layer.scale"] = torch.tensor([0.458, 0.448, 0.450]).reshape(1, 3, 1, 1)

    class LPIPS:
        def __init__(self, net):
            assert net == "alex"

        def state_dict(self):
            return sd

    mod = types.ModuleType("lpips")
    mod.LPIPS = LPIPS
    return mod


def test_convert_torch_lpips_writes_the_jax_packages_file(tmp_path, monkeypatch, rng):
    monkeypatch.setitem(sys.modules, "lpips", _lpips_stand_in(rng))
    ours = convert_torch_lpips(str(tmp_path / "ours.npz"))
    theirs = jax_convert(str(tmp_path / "theirs.npz"))
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files) and len(a.files) == 17
        for k in b.files:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
    # and the port's lpips() reads it
    img = torch.from_numpy(rng.uniform(-1, 1, size=(1, 64, 64, 3)).astype(np.float32))
    d = lpips(img, img.flip(1), weights_path=ours)
    assert d.shape == (1,) and torch.isfinite(d).all()


def test_convert_torch_lpips_without_the_package_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "lpips", None)
    with pytest.raises(ImportError):
        convert_torch_lpips()
