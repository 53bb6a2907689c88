"""The port's factory against the JAX package's: input_dim, flops_per_pixel
and n_params of the teacher and of the mlp, resmlp, layerwise and conv
students, the render configs, --freeze_pretrained and --no_pallas."""
import dataclasses

import numpy as np
import pytest
import torch

from efficient_nerf_tpu import factory as jfactory
from efficient_nerf_tpu.config.options import parse_args as jparse
from efficient_nerf_tpu_torch import factory
from efficient_nerf_tpu_torch.config.options import parse_args
from efficient_nerf_tpu_torch.models import NeRFMLP, R2LConvNet, R2LNet

BASE = ["--dataset_type", "blender", "--N_samples", "4", "--N_importance", "4",
        "--netdepth", "6", "--netwidth", "32", "--netdepth_fine", "6",
        "--netwidth_fine", "32", "--n_sample_per_ray", "4", "--multires", "4"]
CASES = {
    "teacher": ["--model_name", "nerf", "--use_viewdirs"],
    "teacher_noview": ["--model_name", "nerf", "--N_importance", "0", "--skips", "2,4"],
    "mlp": ["--model_name", "R2L", "--use_residual"],
    "resmlp": ["--model_name", "R2L", "--trial.ON", "--trial.body_arch", "resmlp",
               "--trial.n_block", "2", "--linear_tail"],
    "layerwise": ["--model_name", "R2L", "--layerwise_netwidths", "32,16,16,24",
                  "--learn_depth", "depth"],
    "plucker": ["--model_name", "R2L", "--plucker", "--trial.ON",
                "--trial.body_arch", "resmlp"],
    "conv": ["--model_name", "R2L", "--data_mode", "patches", "--kernel_size", "3",
             "--body_arch", "conv"],
    "conv_bn": ["--model_name", "R2L", "--data_mode", "patches", "--kernel_size", "3",
                "--body_arch", "resblock", "--use_bn", "--compute_dtype", "bf16"],
}
KINDS = {"teacher": NeRFMLP, "teacher_noview": NeRFMLP, "mlp": R2LNet, "resmlp": R2LNet,
         "layerwise": R2LNet, "plucker": R2LNet, "conv": R2LConvNet, "conv_bn": R2LConvNet}


@pytest.mark.parametrize("case", sorted(CASES))
def test_create_models_counts_as_jax(case):
    argv = BASE + CASES[case]
    got = factory.create_models(parse_args(argv), 2.0, 6.0, device="cpu")
    want = jfactory.create_models(jparse(argv), 2.0, 6.0)
    assert got.input_dim == want.input_dim
    assert got.flops_per_pixel == want.flops_per_pixel
    assert got.n_params == want.n_params
    nets = got.model.values() if isinstance(got.model, torch.nn.ModuleDict) else [got.model]
    assert all(isinstance(m, KINDS[case]) for m in nets)
    dtype = torch.bfloat16 if "bf16" in argv else torch.float32
    assert all(m.dtype == dtype for m in nets)
    assert all(p.dtype == torch.float32 for p in got.model.parameters())
    # the init is fixed and leaves the process's random state alone
    state = torch.random.get_rng_state()
    again = factory.create_models(parse_args(argv), 2.0, 6.0, device="cpu")
    assert torch.equal(state, torch.random.get_rng_state())
    for a, b in zip(got.model.state_dict().values(), again.model.state_dict().values()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("extra", [[], ["--perturb_test", "1", "--teacher_quant", "int8"],
                                   ["--dataset_type", "llff", "--lindisp", "--exact_embed"]])
def test_render_configs_match_jax(extra):
    argv = BASE + CASES["teacher"] + ["--raw_noise_std", "0.5"] + extra
    got = factory.create_models(parse_args(argv), 2.0, 6.0, device="cpu")
    want = jfactory.create_models(jparse(argv), 2.0, 6.0)
    for mine, theirs in ((got.cfg_train, want.cfg_train), (got.cfg_test, want.cfg_test)):
        d = dataclasses.asdict(mine)
        assert d.pop("kernels") is True
        assert d == dataclasses.asdict(theirs)
    assert got.schedule(0) == pytest.approx(5e-4)   # --lrate, no warmup


def test_no_pallas_turns_the_teacher_kernels_off():
    argv = BASE + CASES["teacher"] + ["--no_pallas"]
    b = factory.create_models(parse_args(argv), 2.0, 6.0, device="cpu")
    assert b.cfg_test.fused_teacher and not b.cfg_test.kernels
    # eval_mode() (the pseudo-data renderer's) keeps them off
    assert not b.cfg_test.eval_mode().kernels
    from efficient_nerf_tpu_torch.render.renderer import _nerf_profile_ok
    assert not _nerf_profile_ok(b.model["coarse"], b.cfg_test.eval_mode())
    assert _nerf_profile_ok(b.model["coarse"], dataclasses.replace(b.cfg_test, kernels=True))


def test_freeze_pretrained_updates_nothing():
    b = factory.create_models(parse_args(BASE + CASES["mlp"] + ["--freeze_pretrained"]),
                              2.0, 6.0, device="cpu")
    before = [p.detach().clone() for p in b.model.parameters()]
    for p in b.model.parameters():
        p.grad = torch.ones_like(p)
    b.optimizer.step()
    assert all(torch.equal(a, p) for a, p in zip(before, b.model.parameters()))


def test_the_teacher_renders_through_the_bundles_own_networks():
    """render_path renders a teacher with the bundle's networks as they are:
    an f32 teacher without viewdirs (lego_noview.txt's profile) stays f32
    and packs nothing for a kernel."""
    from efficient_nerf_tpu_torch.evaluate import render_path

    b = factory.create_models(parse_args(BASE + CASES["teacher_noview"]), 2.0, 6.0,
                              device="cpu")
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = 4.0
    out = render_path(b, pose[None], (4, 4, 5.0), model_name="nerf", log=lambda *a: None)
    assert out["rgbs"].shape == (1, 4, 4, 3) and np.isfinite(out["rgbs"]).all()
    assert all(p.dtype == torch.float32 for p in b.model.parameters())
    assert not any(hasattr(m, "_nerf_pack") for m in b.model.values())