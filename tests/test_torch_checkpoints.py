"""The port's checkpoints against the JAX package, both ways: a port `.tar`
read by the JAX `import_reference_checkpoint` (teacher coarse and fine, the
resmlp student) gives the same params bit for bit; a `.tar` written from
JAX params gives the port's models the same outputs through
--pretrained_ckpt; --resume restores the step, the best PSNR and the Adam
state. The JAX package's own ENTPUCK1 files (the resmlp and `mlp`
students, the conv student, the teacher; with and without the Adam state)
give the port the JAX models' outputs, and resuming one takes the same
next step in both packages; the msgpack decoder against flax's; a
truncated or foreign file raises."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from efficient_nerf_tpu import factory as jfactory
from efficient_nerf_tpu.config.options import parse_args as jparse
from efficient_nerf_tpu.models import torch_import
from efficient_nerf_tpu.train import steps as jsteps
from efficient_nerf_tpu.train.checkpoints import (import_reference_checkpoint,
                                                  restore_train_state as jax_restore,
                                                  save_checkpoint as jax_save)
from efficient_nerf_tpu_torch import factory
from efficient_nerf_tpu_torch.config.options import parse_args
from efficient_nerf_tpu_torch.train import (init_train_state, load_checkpoint,
                                            make_r2l_train_step, make_teacher_train_step,
                                            restore_train_state, save_checkpoint)
from efficient_nerf_tpu_torch.utils.msgpack import msgpack_restore

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


# ---- the JAX package's own ENTPUCK1 files

MLP = ["--model_name", "R2L", "--netdepth", "6", "--netwidth", "16", "--n_sample_per_ray", "4",
       "--multires", "3", "--use_residual"]
CONV = ["--model_name", "R2L", "--data_mode", "patches", "--netdepth", "6", "--netwidth", "16",
        "--n_sample_per_ray", "4", "--multires", "3", "--kernel_size", "3", "--body_arch",
        "resblock", "--use_bn"]
JAX_CASES = {"teacher": TEACHER, "resmlp": STUDENT, "mlp": MLP, "conv": CONV}
# each case's first parameter: the port's name, and its leaf in the JAX tree
# with the transpose that takes the JAX layout to torch's
FIRST = {"teacher": ("coarse.pts_linears.0.weight", ("coarse", "pts_0", "kernel"), (1, 0)),
         "resmlp": ("head.0.weight", ("head", "kernel"), (1, 0)),
         "mlp": ("head.0.weight", ("head", "kernel"), (1, 0)),
         "conv": ("head.weight", ("head", "kernel"), (3, 2, 0, 1))}
# weights after one step, in units of lr, as tests/test_torch_driver.py
# holds the drivers: Adam maps a gradient to about +-lr whatever its size,
# so the packages' f32 disagreement moves a weight by a part of one lr (the
# teacher's fine network sees its depths through the inverse CDF, whose
# sums run in another order). Measured after one step from the same file:
# 6.0e-5 lr (student) and 1.2e-4 lr (teacher)
WEIGHT_TOL_LR = {"student": 0.05, "teacher": 0.1}
LR = 5e-4           # --lrate's default


def _jax_bundle(argv):
    return jfactory.create_models(jparse(["--dataset_type", "blender"] + argv), 2.0, 6.0)


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def _adam_state(jb, rng, n=2):
    """optax.adam's state after n updates of random gradients."""
    state = jb.optimizer.init(jb.params)
    for _ in range(n):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32)), jb.params)
        _, state = jb.optimizer.update(grads, state, jb.params)
    return state


def _jax_outputs(case, jb, x):
    if case == "teacher":
        return {k: np.asarray(jb.model.apply({"params": jb.params[k]}, jnp.asarray(x)))
                for k in ("coarse", "fine")}
    variables = {"params": jb.params}
    if case == "conv":   # the JAX file holds no batch_stats: the init's
        variables["batch_stats"] = jb.model.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, jb.input_dim)))["batch_stats"]
    return {"": np.asarray(jb.model.apply(variables, jnp.asarray(x)))}


@pytest.mark.parametrize("with_opt", [True, False], ids=["adam", "params"])
@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_jax_entpuck1_gives_the_port_the_same_outputs(case, with_opt, tmp_path, rng):
    argv = JAX_CASES[case]
    jb = _jax_bundle(argv)
    opt_state = _adam_state(jb, rng) if with_opt else None
    path = jax_save(str(tmp_path / "ckpt.msgpack"), jb.params, opt_state, step=5,
                    best_psnr=21.5, best_psnr_step=4, model_config={"netdepth": 6})
    ckpt = load_checkpoint(path)
    assert (ckpt["global_step"], ckpt["best_psnr"], ckpt["best_psnr_step"]) == (5, 21.5, 4)
    assert ckpt["model_config"] == {"netdepth": 6}
    b = _bundle(argv + ["--pretrained_ckpt", path, "--resume"])
    assert b.history == {"start": 5, "best_psnr": 21.5, "best_psnr_step": 4}
    shape = ((7, 5, 4, jb.input_dim) if case == "conv" else
             (9, 42) if case == "teacher" else (9, jb.input_dim))
    x = rng.normal(size=shape).astype(np.float32)
    b.model.eval()
    with torch.no_grad():
        for k, want in _jax_outputs(case, jb, x).items():
            got = (b.model[k] if k else b.model)(torch.from_numpy(x)).numpy()
            np.testing.assert_allclose(got, want, atol=OUT_TOL, rtol=0)
    if not with_opt:
        assert b.restored_opt_state is None
        return
    b.optimizer.load_state_dict(b.restored_opt_state)
    state = b.optimizer.state_dict()["state"]
    names = [n for n, _ in b.model.named_parameters()]
    assert sorted(state) == list(range(len(names)))
    assert all(float(s["step"]) == 2.0 for s in state.values())
    name, leaf, perm = FIRST[case]
    i = names.index(name)
    for ours, theirs in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
        want = _leaf(getattr(opt_state[0], theirs), leaf).transpose(perm)
        np.testing.assert_array_equal(state[i][ours].numpy(), want)


def test_jax_entpuck1_of_a_frozen_run_has_no_adam_state(tmp_path):
    jb = _jax_bundle(STUDENT)
    path = jax_save(str(tmp_path / "ckpt.msgpack"), jb.params,
                    optax.set_to_zero().init(jb.params), step=3)
    b = _bundle(STUDENT + ["--pretrained_ckpt", path, "--resume", "--freeze_pretrained"])
    assert b.history["start"] == 3 and b.restored_opt_state is None


def _student_steps(jb, b):
    kw = dict(near=2.0, far=6.0, n_sample=4, L=3, perturb=False, fast_embed=False)
    jstep = jsteps.make_r2l_train_step(jb.model, jb.optimizer, donate=False, **kw)
    tstep = make_r2l_train_step(b.model, b.optimizer, schedule=b.schedule, device="cpu", **kw)

    def run_jax(state, batch):
        return jstep(state, None, jax.random.PRNGKey(0), *map(jnp.asarray, batch))[0]

    def run_port(state, batch):
        return tstep(state, None, torch.Generator().manual_seed(0),
                     *map(torch.from_numpy, batch))[0]

    return run_jax, run_port


def _teacher_steps(jb, b):
    jstep = jsteps.make_teacher_train_step(jb.model, jb.optimizer, jb.cfg_train, donate=False)
    tstep = make_teacher_train_step(b.model["coarse"], b.model["fine"], b.optimizer,
                                    b.cfg_train, schedule=b.schedule, device="cpu")

    def run_jax(state, batch):
        return jstep(state, jax.random.PRNGKey(0), *map(jnp.asarray, batch))[0]

    def run_port(state, batch):
        return tstep(state, torch.Generator().manual_seed(0), *map(torch.from_numpy, batch))[0]

    return run_jax, run_port


@pytest.mark.parametrize("model", ["student", "teacher"])
def test_resume_from_a_jax_entpuck1_takes_the_same_step(model, tmp_path, rng):
    argv = (STUDENT if model == "student" else TEACHER) + [
        "--perturb", "0", "--raw_noise_std", "0", "--exact_embed"]
    jb = _jax_bundle(argv)
    steps = _student_steps if model == "student" else _teacher_steps

    def batch():
        o = rng.normal(size=(32, 3)).astype(np.float32) * 0.1
        d = rng.normal(size=(32, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        return o, d, rng.uniform(size=(32, 3)).astype(np.float32)

    # two JAX steps, so that the file's Adam state has moments and a count
    run_jax, _ = steps(jb, _bundle(argv))
    jstate = jsteps.init_train_state(jb.params, jb.optimizer)
    for _ in range(2):
        jstate = run_jax(jstate, batch())
    path = jax_save(str(tmp_path / "ckpt.msgpack"), jstate.params, jstate.opt_state,
                    step=int(jstate.step))
    # the JAX package restores with its templates; the port through --resume
    _, jstate = jax_restore(path, jsteps.init_train_state(jb.params, jb.optimizer))
    b = _bundle(argv + ["--pretrained_ckpt", path, "--resume"])
    state = init_train_state(b.model, b.optimizer)._replace(step=b.history["start"])
    b.optimizer.load_state_dict(b.restored_opt_state)
    run_jax, run_port = steps(jb, b)
    one = batch()
    jstate, state = run_jax(jstate, one), run_port(state, one)
    assert state.step == int(jstate.step) == 3
    if model == "student":
        want = torch_import.r2l_state_dict_from_params(jstate.params)
    else:
        want = {f"{k}.{n}": v for k in ("coarse", "fine") for n, v in
                torch_import.nerf_state_dict_from_params(jstate.params[k], depth=3).items()}
    got = b.model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        err = np.abs(got[k].numpy() - np.asarray(v)).max() / LR
        assert err <= WEIGHT_TOL_LR[model], (k, err)


def _random_tree(rng, depth=0):
    """A random state dict of the leaf kinds flax writes."""
    leaves = [
        lambda: rng.normal(size=tuple(rng.integers(1, 5, size=rng.integers(0, 4))))
        .astype(rng.choice(["float32", "float64", "float16"])),
        lambda: rng.integers(-2**40, 2**40, size=rng.integers(1, 6)).astype(
            rng.choice(["int8", "int16", "int32", "int64", "uint8", "uint32"])),
        lambda: np.asarray(rng.uniform(size=3) > 0.5),
        lambda: int(rng.choice([0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, 2**63 - 1,
                                -1, -32, -33, -128, -129, -32768, -32769, -2**31 - 1,
                                -2**63])),
        lambda: float(rng.normal()),
        lambda: str(rng.choice(["", "a", "µs", "x" * 40, "y" * 300])),
        lambda: bool(rng.uniform() > 0.5),
        lambda: None,
        lambda: getattr(np, str(rng.choice(["float32", "int32", "int64", "float64"])))(
            rng.normal() * 100),
        lambda: [1, "two", 3.0],
    ]
    tree = {}
    for i in range(int(rng.integers(2, 6))):
        if depth < 3 and rng.uniform() < 0.3:
            tree[f"node{i}"] = _random_tree(rng, depth + 1)
        else:
            tree[f"leaf{i}"] = leaves[int(rng.integers(len(leaves)))]()
    return tree


def _assert_same(got, want, where=""):
    assert type(got) is type(want), (where, type(got), type(want))
    if isinstance(want, dict):
        assert list(got) == list(want), where
        for k in want:
            _assert_same(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for a, b in zip(got, want):
            _assert_same(a, b, where)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, where
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want or (got != got and want != want), (where, got, want)


@pytest.mark.parametrize("seed", range(4))
def test_msgpack_decoder_matches_flax(seed):
    tree = _random_tree(np.random.default_rng(seed))
    tree["complex"] = complex(1.5, -2.0)
    blob = serialization.msgpack_serialize(tree)
    _assert_same(msgpack_restore(blob), serialization.msgpack_restore(blob))


def test_msgpack_decoder_joins_chunked_arrays(monkeypatch, rng):
    tree = {"w": rng.normal(size=(5, 7)).astype(np.float32),
            "n": {"i": np.arange(40, dtype=np.int64)}, "s": rng.normal(size=3)}
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 32)
    blob = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in blob
    got = msgpack_restore(blob)
    _assert_same(got, serialization.msgpack_restore(blob))
    np.testing.assert_array_equal(got["w"], tree["w"])


def test_msgpack_decoder_widens_bfloat16(rng):
    x = jnp.asarray(rng.normal(size=(3, 4)), jnp.bfloat16)
    got = msgpack_restore(serialization.msgpack_serialize({"x": x}))["x"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(x, np.float32))


def test_a_truncated_or_foreign_file_raises(tmp_path):
    path = jax_save(str(tmp_path / "ckpt.msgpack"), {"w": jnp.zeros(3)})
    blob = open(path, "rb").read()
    for name, data in (("short", blob[:-5]), ("header", blob[:12]),
                       ("foreign", b"not a checkpoint at all")):
        bad = tmp_path / name
        bad.write_bytes(data)
        with pytest.raises(ValueError, match="ENTPUCK1"):
            load_checkpoint(str(bad))
    with pytest.raises(ValueError, match="ENTPUCK1"):
        _bundle(STUDENT + ["--pretrained_ckpt", str(tmp_path / "short")])
