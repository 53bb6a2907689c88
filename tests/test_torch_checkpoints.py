"""The port's checkpoints against the JAX package, both ways: a port `.tar`
read by the JAX `import_reference_checkpoint` (teacher coarse and fine, the
resmlp student) gives the same params bit for bit; a `.tar` written from
JAX params gives the port's models the same outputs through
--pretrained_ckpt; --resume restores the step, the best PSNR and the Adam
state; a JAX-native ENTPUCK1 file raises."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_nerf_tpu.models import torch_import
from efficient_nerf_tpu.train.checkpoints import (import_reference_checkpoint,
                                                  save_checkpoint as jax_save)
from efficient_nerf_tpu_torch import factory
from efficient_nerf_tpu_torch.config.options import parse_args
from efficient_nerf_tpu_torch.train import (init_train_state, load_checkpoint,
                                            restore_train_state, save_checkpoint)

TEACHER = ["--model_name", "nerf", "--use_viewdirs", "--netdepth", "3", "--netwidth", "16",
           "--netdepth_fine", "3", "--netwidth_fine", "16", "--multires", "4",
           "--multires_views", "2", "--skips", "1", "--N_importance", "4"]
STUDENT = ["--model_name", "R2L", "--trial.ON", "--trial.body_arch", "resmlp",
           "--netdepth", "6", "--netwidth", "16", "--n_sample_per_ray", "4",
           "--multires", "3", "--use_residual"]
# the port's f32 linears against flax's Dense (another summation order)
OUT_TOL = 1e-5


def _bundle(argv):
    return factory.create_models(parse_args(["--dataset_type", "blender"] + argv), 2.0, 6.0,
                                 device="cpu")


def test_port_teacher_tar_reads_in_jax_bit_for_bit(tmp_path):
    b = _bundle(TEACHER)
    path = save_checkpoint(str(tmp_path / "t.tar"), b.model, b.optimizer, step=7,
                           best_psnr=12.5, best_psnr_step=4, model_config={"netdepth": 3})
    meta, params = import_reference_checkpoint(path, "nerf", depth=3, use_viewdirs=True)
    assert meta == {"step": 7, "best_psnr": 12.5}
    for name in ("coarse", "fine"):
        sd = {k: v.numpy() for k, v in b.model[name].state_dict().items()}
        want = torch_import.nerf_params_from_state_dict(sd, depth=3, use_viewdirs=True)
        assert params[name].keys() == want.keys()
        for layer, leaves in want.items():
            for leaf, value in leaves.items():
                np.testing.assert_array_equal(params[name][layer][leaf], value)
    assert load_checkpoint(path)["model_config"] == {"netdepth": 3}


def test_port_student_tar_reads_in_jax_bit_for_bit(tmp_path):
    b = _bundle(STUDENT)
    path = save_checkpoint(str(tmp_path / "s.tar"), b.model, step=3)
    meta, params = import_reference_checkpoint(path, "r2l", n_block=2, n_learnable=2)
    assert meta["step"] == 3
    sd = b.model.state_dict()
    np.testing.assert_array_equal(params["head"]["kernel"], sd["head.0.weight"].numpy().T)
    for blk in range(2):
        for j in range(2):
            np.testing.assert_array_equal(params["body"][f"lin_{j}"]["kernel"][blk],
                                          sd[f"body.{blk}.body.{2 * j}.weight"].numpy().T)
            np.testing.assert_array_equal(params["body"][f"lin_{j}"]["bias"][blk],
                                          sd[f"body.{blk}.body.{2 * j}.bias"].numpy())
    np.testing.assert_array_equal(params["tail"]["bias"], sd["tail.0.bias"].numpy())


def _jax_tar(path, state_dicts):
    torch.save({k: {n: torch.tensor(np.asarray(v)) for n, v in sd.items()}
                for k, sd in state_dicts.items()} | {"global_step": 11}, path)
    return path


def test_jax_teacher_tar_gives_the_port_the_same_outputs(tmp_path, rng):
    from efficient_nerf_tpu.models import NeRFMLP as JaxNeRFMLP

    jm = JaxNeRFMLP(depth=3, width=16, input_ch=27, input_ch_views=15, skips=(1,),
                    output_ch=5)
    x = rng.normal(size=(9, 42)).astype(np.float32)
    params = {k: jm.init(jax.random.PRNGKey(i), jnp.zeros((1, 42)))["params"]
              for i, k in enumerate(("coarse", "fine"))}
    sds = {f"network_{n}_state_dict": torch_import.nerf_state_dict_from_params(
        params[k], depth=3) for n, k in (("fn", "coarse"), ("fine", "fine"))}
    path = _jax_tar(str(tmp_path / "j.tar"), sds)
    b = _bundle(TEACHER + ["--pretrained_ckpt", path])
    assert b.history["start"] == 0          # no --resume: weights only
    for name in ("coarse", "fine"):
        got = b.model[name](torch.from_numpy(x)).detach().numpy()
        want = np.asarray(jm.apply({"params": params[name]}, jnp.asarray(x)))
        np.testing.assert_allclose(got, want, atol=OUT_TOL, rtol=0)


def test_jax_student_tar_gives_the_port_the_same_outputs(tmp_path, rng):
    from efficient_nerf_tpu.models import R2LNet as JaxR2LNet

    jm = JaxR2LNet(input_dim=84, depth=6, width=16, use_residual=True)
    x = rng.normal(size=(9, 84)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(2), jnp.zeros((1, 84)))["params"]
    sd = torch_import.r2l_state_dict_from_params(params)
    path = _jax_tar(str(tmp_path / "j.tar"), {"network_fn_state_dict": sd})
    b = _bundle(STUDENT + ["--pretrained_ckpt", path])
    got = b.model(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply({"params": params}, jnp.asarray(x))),
                               atol=OUT_TOL, rtol=0)


def test_resume_restores_step_best_psnr_and_adam_state(tmp_path, rng):
    b = _bundle(STUDENT)
    x = torch.from_numpy(rng.normal(size=(16, 84)).astype(np.float32))
    for _ in range(2):     # two Adam steps, so the optimizer has its moments
        b.optimizer.zero_grad()
        b.model(x).square().mean().backward()
        b.optimizer.step()
    path = save_checkpoint(str(tmp_path / "r.tar"), b.model, b.optimizer, step=2,
                           best_psnr=9.25, best_psnr_step=2)
    r = _bundle(STUDENT + ["--pretrained_ckpt", path, "--resume"])
    assert r.history == {"start": 2, "best_psnr": 9.25, "best_psnr_step": 2}
    r.optimizer.load_state_dict(r.restored_opt_state)
    want, got = b.optimizer.state_dict(), r.optimizer.state_dict()
    assert got["param_groups"] == want["param_groups"]
    for i, s in want["state"].items():
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(got["state"][i][k], s[k]), (i, k)
    for p, q in zip(b.model.parameters(), r.model.parameters()):
        assert torch.equal(p, q)
    # restore_train_state does the same into a TrainState
    fresh = _bundle(STUDENT)
    meta, state = restore_train_state(path, init_train_state(fresh.model, fresh.optimizer))
    assert state.step == 2 and meta["best_psnr"] == 9.25
    assert torch.equal(fresh.optimizer.state_dict()["state"][0]["exp_avg"],
                       want["state"][0]["exp_avg"])
    # without --resume the weights load and the history starts over
    assert _bundle(STUDENT + ["--pretrained_ckpt", path]).history["start"] == 0


def test_jax_native_checkpoint_raises(tmp_path):
    path = jax_save(str(tmp_path / "ckpt.msgpack"), {"w": jnp.zeros(3)})
    with pytest.raises(ValueError, match="ENTPUCK1"):
        load_checkpoint(path)
    with pytest.raises(ValueError, match="ENTPUCK1"):
        _bundle(STUDENT + ["--pretrained_ckpt", path])
