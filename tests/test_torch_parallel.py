"""The port's multi-process training and serving (`efficient_nerf_tpu_torch.
parallel`) against the JAX package's `parallel` on the conftest's virtual
CPU mesh, and against the port's own single-process steps.

The port's ranks are processes (_torch_parallel_worker.py, started with
subprocess), joined in a gloo group through a FileStore under the test's
tmp_path, one thread each. One group of two ranks serves the data-parallel,
tensor-parallel, serving, teacher and API cases in turn, one mesh each; one
group of four ranks the 2x2 case with the hard pool. The JAX side runs in
this process while the ranks run; JAX is imported inside the functions
only. Weights cross with `load_state_dict` of the converted JAX params, and
random draws as numpy arrays through the steps' `noise=` hooks.

Tolerances are the JAX package's own tests' (tests/test_parallel.py): the
loss to 1e-5 relative and the weights after one Adam step at lr 1e-3 to
2e-5 (0.02 lr; Adam's first step maps a gradient to about +-lr, so a
disagreement of the gradients shows as a part of one lr); the sharded
forward to 1e-5; the teacher step as tests/test_torch_teacher_train.py
holds it with exact embeds (loss 1e-5, weights 0.05 lr). The sharded
port against the single-process port: the same arithmetic on the same rows
but for the order of the sums over rows, so their gradients are held to
1e-5 of each tensor's largest entry.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from efficient_nerf_tpu_torch.core.rays import get_rays_np
from efficient_nerf_tpu_torch.models import NeRFMLP, R2LNet
from efficient_nerf_tpu_torch.models.weights import (nerf_state_dict_from_params,
                                                     r2l_state_dict_from_params)
from efficient_nerf_tpu_torch.parallel import host_subset, make_mesh
from efficient_nerf_tpu_torch.render import RenderConfig
from efficient_nerf_tpu_torch.train import (hard_pool_init, init_train_state,
                                            make_r2l_train_step, make_teacher_train_step)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_parallel_worker.py")
RANK_TIMEOUT = 240

N_SAMPLE, L, NEAR, FAR, LR = 4, 10, 2.0, 6.0, 1e-3
IN_DIM = N_SAMPLE * 3 * (2 * L + 1)
LOSS_RTOL, PARAM_ATOL, FWD_ATOL = 1e-5, 2e-5, 1e-5
SELF_GRAD_TOL = 1e-5       # sharded port vs single port, of the largest entry
T_DEPTH, T_WIDTH, T_HWF, T_B = 2, 32, (16, 16, 20.0), 64
T_CFG = dict(n_samples=8, n_importance=4, perturb=True, use_viewdirs=True, ndc=True,
             near=0.0, far=1.0, fast_embed=False)
T_LR, T_PARAM_TOL_LR = 5e-4, 0.05


# ---------------------------------------------------------------- helpers

def _start(tmp, world, cases):
    """Start `world` ranks on the cases; returns the processes."""
    spec = {"store": str(tmp / "store"), "cases": cases}
    torch.save(spec, tmp / "spec.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return [subprocess.Popen([sys.executable, WORKER, str(tmp / "spec.pt"), str(r),
                              str(world)], stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
            for r in range(world)]


def _collect(tmp, procs):
    """Every rank's results; a rank that fails or times out fails the test."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    return [torch.load(tmp / f"out_{r}.pt", weights_only=False) for r in range(len(procs))]


def _rays(rng, n):
    o = rng.normal(size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    t = rng.uniform(size=(n, 3)).astype(np.float32)
    return o, d, t


def _jax_r2l(depth=4, width=16, in_dim=IN_DIM, seed=0):
    """The JAX test's student (_r2l_setup) and its params, and the state_dict."""
    import jax
    import jax.numpy as jnp

    from efficient_nerf_tpu.models import R2LNet as JaxR2LNet

    jm = JaxR2LNet(input_dim=in_dim, depth=depth, width=width)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, in_dim)))["params"]
    sd = r2l_state_dict_from_params(jax.tree_util.tree_map(np.asarray, params))
    return jm, params, {k: torch.tensor(np.asarray(v)) for k, v in sd.items()}


def _jax_sd(params):
    import jax

    sd = r2l_state_dict_from_params(jax.tree_util.tree_map(np.asarray, params))
    return {k: np.asarray(v) for k, v in sd.items()}


def _port_single(sd, model_kw, batches, hard=None, pool=4, perturb=False, seed=0, **kw):
    """The port's single-process step over the batches: (metrics, pools,
    model) after them."""
    model = R2LNet(**model_kw)
    model.load_state_dict(sd)
    opt = torch.optim.Adam(model.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8)
    step = make_r2l_train_step(model, opt, near=NEAR, far=FAR, n_sample=N_SAMPLE, L=L,
                               perturb=perturb, hard=hard, device="cpu", **kw)
    state, p = init_train_state(model, opt), hard_pool_init(pool, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    mets, pools = [], []
    for o, d, t, noise in batches:
        state, p, m = step(state, p, gen, torch.from_numpy(o), torch.from_numpy(d),
                           torch.from_numpy(t), noise=noise)
        mets.append({k: float(v) for k, v in m.items()})
        pools.append((p.rays.clone(), p.count))
    return mets, pools, model


def _r2l_case(mesh, sd, model_kw, batches, hard=None, pool=4, perturb=False, seed=0, **kw):
    return {"kind": "r2l_step", "mesh": mesh, "model": model_kw, "state_dict": sd,
            "lr": LR, "near": NEAR, "far": FAR, "n_sample": N_SAMPLE, "L": L,
            "perturb": perturb, "hard": hard, "pool": pool, "seed": seed,
            "batches": batches, "kw": kw}


def _jax_sharded_step(jm, params, mesh, o, d, t, **kw):
    """One step of the JAX package's make_sharded_r2l_train_step: (loss,
    state_dict after Adam)."""
    import jax
    import optax

    from efficient_nerf_tpu.parallel import make_sharded_r2l_train_step, shard_batch
    from efficient_nerf_tpu.parallel.train import replicate_state
    from efficient_nerf_tpu.train import hard_pool_init as jpool, init_train_state as jinit

    opt = optax.adam(LR)
    step = make_sharded_r2l_train_step(jm, opt, mesh, near=NEAR, far=FAR,
                                       n_sample=N_SAMPLE, perturb=False, donate=False, **kw)
    if mesh.shape["model"] > 1:
        from efficient_nerf_tpu.parallel import shard_params_tp

        state, pool = jinit(shard_params_tp(mesh, params), opt), replicate_state(mesh, jpool(4))
    else:
        state, pool = replicate_state(mesh, jinit(params, opt), jpool(4))
    state, _, m = step(state, pool, jax.random.PRNGKey(1), *shard_batch(mesh, o, d, t))
    return float(m["loss_rgb"]), _jax_sd(jax.device_get(state.params))


def _max_diff(got, want):
    return max(np.abs(np.asarray(got[k]) - np.asarray(want[k])).max() for k in want)


def _assert_grads_close(got, want, tol):
    for k, w in want.items():
        w = np.asarray(w)
        err = np.abs(np.asarray(got[k]) - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= tol, (k, err)


# ---------------------------------------------------------------- two ranks

def _teacher_inputs(rng):
    """Dryrun stage 4's teacher (NDC, view dirs) from the flax init, a batch
    of forward-facing rays and the JAX step's draws for it."""
    import jax
    import jax.numpy as jnp

    from efficient_nerf_tpu.core import sampling as jsamp
    from efficient_nerf_tpu.models import NeRFMLP as JaxNeRFMLP

    jm = JaxNeRFMLP(depth=T_DEPTH, width=T_WIDTH, input_ch=63, input_ch_views=27,
                    use_viewdirs=True)
    params = {name: jm.init(jax.random.PRNGKey(s), jnp.zeros((1, 90)))["params"]
              for name, s in (("coarse", 2), ("fine", 4))}
    c2w = np.concatenate([np.eye(3, dtype=np.float32),
                          np.array([[0.1], [0.2], [0.3]], np.float32)], 1)
    o, d = get_rays_np(*T_HWF, c2w)
    pick = rng.permutation(T_HWF[0] * T_HWF[1])[:T_B]
    o = np.ascontiguousarray(o.reshape(-1, 3)[pick], np.float32)
    d = np.ascontiguousarray(d.reshape(-1, 3)[pick], np.float32)
    t = rng.uniform(size=(T_B, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    k_strat, k_pdf, _, _ = jax.random.split(key, 4)
    noise = {"t_rand": torch.tensor(np.asarray(jax.random.uniform(k_strat, (T_B, 8)))),
             "u": torch.tensor(np.asarray(jsamp.sorted_uniform(k_pdf, (T_B, 4))))}
    sds = {name: {k: torch.tensor(np.asarray(v)) for k, v in nerf_state_dict_from_params(
        jax.tree_util.tree_map(np.asarray, p), T_DEPTH, True).items()}
           for name, p in params.items()}
    return jm, params, o, d, t, key, noise, sds


def _jax_teacher(jm, params, o, d, t, key):
    import jax
    import optax

    from efficient_nerf_tpu.parallel import make_mesh as jmake_mesh
    from efficient_nerf_tpu.parallel import make_sharded_teacher_train_step, shard_batch
    from efficient_nerf_tpu.parallel.train import replicate_state
    from efficient_nerf_tpu.render import RenderConfig as JaxRenderConfig
    from efficient_nerf_tpu.train import init_train_state as jinit

    mesh = jmake_mesh(n_data=2, devices=jax.devices()[:2])
    opt = optax.adam(T_LR, b1=0.9, b2=0.999)
    step = make_sharded_teacher_train_step(jm, opt, mesh, JaxRenderConfig(**T_CFG), hwf=T_HWF,
                                           donate=False)
    state = replicate_state(mesh, jinit(params, opt))
    state, m = step(state, key, *shard_batch(mesh, o, d, t))
    p = jax.device_get(state.params)
    return float(m["loss"]), {
        f"{name}.{k}": np.asarray(v) for name in p for k, v in nerf_state_dict_from_params(
            jax.tree_util.tree_map(np.asarray, p[name]), T_DEPTH, True).items()}


def _teacher_case(sds, o, d, t, noise, seed=None, **cfg):
    return {"kind": "teacher", "mesh": (2, 1), "model": dict(depth=T_DEPTH, width=T_WIDTH),
            "state_dicts": sds, "lr": T_LR, "cfg": dict(T_CFG, **cfg), "hwf": T_HWF,
            "rays_o": o, "rays_d": d, "target": t, "noise": noise, "seed": seed}


def _port_teacher_single(sds, o, d, t, noise, seed=None, **cfg):
    models = {k: NeRFMLP(depth=T_DEPTH, width=T_WIDTH) for k in sds}
    for k, m in models.items():
        m.load_state_dict(sds[k])
    opt = torch.optim.Adam([p for m in models.values() for p in m.parameters()], lr=T_LR,
                           betas=(0.9, 0.999), eps=1e-8)
    step = make_teacher_train_step(models["coarse"], models["fine"], opt,
                                   RenderConfig(**dict(T_CFG, **cfg)), hwf=T_HWF,
                                   device="cpu")
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    _, m = step(init_train_state(torch.nn.ModuleDict(models), opt), gen,
                *(torch.from_numpy(a) for a in (o, d, t)), noise=noise)
    return float(m["loss"]), {f"{k}.{n}": p.grad.clone() for k, mm in models.items()
                              for n, p in mm.named_parameters()}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Start two ranks on every two-rank case, compute the JAX side and the
    single-process port meanwhile; returns (cases' references, ranks'
    results)."""
    import jax

    from efficient_nerf_tpu.parallel import make_mesh as jmake_mesh

    rng = np.random.default_rng(0)
    tmp = tmp_path_factory.mktemp("two_ranks")
    small = dict(input_dim=IN_DIM, depth=4, width=16)
    jm, params, sd = _jax_r2l()
    o, d, t = _rays(rng, 64)
    o16, d16, t16 = _rays(rng, 16)
    fwd_kw = dict(input_dim=N_SAMPLE * 3 * 9, depth=6, width=32)
    jf, fparams, fsd = _jax_r2l(depth=6, width=32, in_dim=N_SAMPLE * 3 * 9)
    fo, fd, _ = _rays(rng, 64)
    tj, tparams, to, td, tt, tkey, tnoise, tsds = _teacher_inputs(rng)
    cases = {
        "dp": _r2l_case((2, 1), sd, small, [(o, d, t, None)], fused=False),
        "dp_fused": _r2l_case((2, 1), sd, small, [(o, d, t, None)], fused=True),
        "tp": _r2l_case((1, 2), sd, small, [(o16, d16, t16, None)]),
        "forward": {"kind": "forward", "mesh": (2, 1), "model": fwd_kw, "state_dict": fsd,
                    "near": NEAR, "far": FAR, "n_sample": N_SAMPLE, "L": 4,
                    "rays_o": fo, "rays_d": fd},
        "teacher": _teacher_case(tsds, to, td, tt, tnoise),
        # every draw (t_rand, both passes' sigma noise, u) from one seed
        "teacher_noise": _teacher_case(tsds, to, td, tt, None, seed=9, raw_noise_std=1.0),
        "api": {"kind": "api", "mesh": (2, 1), "files": [f"s{i}.npy" for i in range(9)]},
    }
    procs = _start(tmp, 2, cases)
    try:
        ref = {}
        dp = jmake_mesh(n_data=2, devices=jax.devices()[:2])
        ref["dp"] = {"jax": _jax_sharded_step(jm, params, dp, o, d, t),
                     "single": _port_single(sd, small, [(o, d, t, None)], fused=False)}
        ref["dp_fused"] = {"jax": _jax_sharded_step(jm, params, dp, o, d, t, fused=True,
                                                    interpret=True),
                           "single": _port_single(sd, small, [(o, d, t, None)], fused=True)}
        tp = jmake_mesh(n_data=1, n_model=2, devices=jax.devices()[:2])
        ref["tp"] = {"jax": _jax_sharded_step(jm, params, tp, o16, d16, t16),
                     "single": _port_single(sd, small, [(o16, d16, t16, None)], fused=False),
                     "state_dict": sd}
        from efficient_nerf_tpu.parallel import make_sharded_r2l_forward, shard_batch

        fn = make_sharded_r2l_forward(jf, dp, near=NEAR, far=FAR, n_sample=N_SAMPLE, L=4)
        ref["forward"] = np.asarray(fn(fparams, *shard_batch(dp, fo, fd)))
        ref["teacher"] = {"jax": _jax_teacher(tj, tparams, to, td, tt, tkey),
                          "single": _port_teacher_single(tsds, to, td, tt, tnoise)}
        ref["teacher_noise"] = _port_teacher_single(tsds, to, td, tt, None, seed=9,
                                                    raw_noise_std=1.0)
    except BaseException:
        for p in procs:
            p.kill()
        raise
    return ref, _collect(tmp, procs)


def _check_r2l_step(ref, ranks, name):
    (j_loss, j_sd), (s_mets, _, s_model) = ref[name]["jax"], ref[name]["single"]
    for r, res in enumerate(ranks):
        got = res[name]
        assert got["step"] == 1
        loss = got["steps"][0]["metrics"]["loss_rgb"]
        np.testing.assert_allclose(loss, j_loss, rtol=LOSS_RTOL, err_msg=f"rank {r}")
        np.testing.assert_allclose(loss, s_mets[0]["loss_rgb"], rtol=LOSS_RTOL)
        params = {k: v.numpy() for k, v in got["params"].items()}
        assert _max_diff(params, j_sd) <= PARAM_ATOL, (r, _max_diff(params, j_sd))
        single = {k: v.detach().numpy() for k, v in s_model.state_dict().items()}
        assert _max_diff(params, single) <= PARAM_ATOL
        _assert_grads_close(got["grads"], {k: p.grad for k, p in s_model.named_parameters()},
                            SELF_GRAD_TOL)
    # the ranks hold one replica
    for k, v in ranks[0][name]["params"].items():
        assert torch.equal(v, ranks[1][name]["params"][k]), k


def test_data_parallel_step_matches_jax_and_the_single_step(two_ranks):
    """2 data ranks, unfused, against JAX make_sharded_r2l_train_step on 2
    virtual devices (tests/test_parallel.py:32-63) and the port's step."""
    _check_r2l_step(*two_ranks, "dp")


def test_data_parallel_fused_step_matches_jax_and_the_single_step(two_ranks):
    """fused=True: the training kernels' plain versions on each rank's rows,
    against the JAX fused step shard_map'ed in interpret mode
    (:142-192)."""
    _check_r2l_step(*two_ranks, "dp_fused")


def test_tensor_parallel_step_matches_the_single_step_and_jax(two_ranks):
    """1x2 'model' mesh, the paired column/row split (:195-228); the
    slices gathered back are the weights they were cut from."""
    ref, ranks = two_ranks
    for res in ranks:
        assert res["tp"]["gathered_equal"]
    _check_r2l_step(ref, ranks, "tp")


def test_sharded_forward_matches_jax(two_ranks):
    ref, ranks = two_ranks
    for res in ranks:
        assert res["forward"]["rows"] == 32
        np.testing.assert_allclose(res["forward"]["rgb"].numpy(), ref["forward"],
                                   atol=FWD_ATOL, rtol=0)


def test_sharded_teacher_step_matches_jax_and_the_single_step(two_ranks):
    """Dryrun stage 4's NDC teacher step over 2 data ranks, the JAX step's
    draws fed in, against JAX make_sharded_teacher_train_step."""
    ref, ranks = two_ranks
    (j_loss, j_params), (s_loss, s_grads) = ref["teacher"]["jax"], ref["teacher"]["single"]
    for res in ranks:
        got = res["teacher"]
        assert got["step"] == 1
        np.testing.assert_allclose(got["metrics"]["loss"], j_loss, rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["metrics"]["loss"], s_loss, rtol=LOSS_RTOL)
        params = {k: v.numpy() for k, v in got["params"].items()}
        assert _max_diff(params, j_params) <= T_PARAM_TOL_LR * T_LR
        _assert_grads_close(got["grads"], s_grads, SELF_GRAD_TOL)


def test_sharded_teacher_step_draws_what_the_single_step_draws(two_ranks):
    """raw_noise_std 1 and no noise handed in: the ranks draw the global
    batch's t_rand, coarse and fine sigma noise and u from one seed in the
    single step's order, and each renders its rows of them."""
    ref, ranks = two_ranks
    s_loss, s_grads = ref["teacher_noise"]
    for res in ranks:
        np.testing.assert_allclose(res["teacher_noise"]["metrics"]["loss"], s_loss,
                                   rtol=LOSS_RTOL)
        _assert_grads_close(res["teacher_noise"]["grads"], s_grads, SELF_GRAD_TOL)


def test_mesh_and_batch_gates(two_ranks):
    """make_mesh refuses a shape that is not the world, shard_batch a batch
    that does not divide; a second initialize_distributed returns; host_subset
    defaults to this rank and the world size; rank r sits at (r // n_model,
    r % n_model)."""
    _, ranks = two_ranks
    for r, res in enumerate(ranks):
        api = res["api"]
        assert api["make_mesh_error"] == "mesh 3x1 != 2 ranks"
        assert "do not divide" in api["shard_batch_error"]
        assert api["subset"] == api["subset_explicit"]
        assert api["mesh"] == ({"data": 2, "model": 1}, r, 0)
    assert sorted(ranks[0]["api"]["subset"] + ranks[1]["api"]["subset"]) == \
        [f"s{i}.npy" for i in range(9)]


# ---------------------------------------------------------------- four ranks

def test_dp_tp_step_with_hard_pool(tmp_path):
    """2x2 data x model mesh, hard=(8, 8), three perturbed steps from one
    seeded generator on every rank (tests/test_parallel.py:66-83): finite
    losses, the pool's 24 rows alike on every rank, and the losses and pool
    of the single-process step drawing from the same seed."""
    rng = np.random.default_rng(1)
    _, _, sd = _jax_r2l()
    small = dict(input_dim=IN_DIM, depth=4, width=16)
    o, d, t = _rays(rng, 32)
    batches = [(o, d, t, None)] * 3
    procs = _start(tmp_path, 4, {"dp_tp": _r2l_case(
        (2, 2), sd, small, batches, hard=(8, 8), pool=64, perturb=True, seed=5)})
    try:
        mets, pools, _ = _port_single(sd, small, batches, hard=(8, 8), pool=64,
                                      perturb=True, seed=5, fused=False)
    except BaseException:
        for p in procs:
            p.kill()
        raise
    ranks = _collect(tmp_path, procs)
    for r, res in enumerate(ranks):
        steps = res["dp_tp"]["steps"]
        for i, s in enumerate(steps):
            assert np.isfinite(s["metrics"]["loss_rgb"])
            np.testing.assert_allclose(s["metrics"]["loss_rgb"], mets[i]["loss_rgb"],
                                       rtol=LOSS_RTOL, err_msg=f"rank {r} step {i}")
            assert s["count"] == pools[i][1] == 8 * (i + 1)
            np.testing.assert_allclose(s["pool"].numpy(), pools[i][0].numpy(), atol=1e-6,
                                       rtol=0)
            assert torch.equal(s["pool"], ranks[0]["dp_tp"]["steps"][i]["pool"])
        assert steps[-1]["count"] == 24


# ---------------------------------------------------------------- one process

def test_host_subset_matches_jax():
    from efficient_nerf_tpu.parallel import host_subset as jhost_subset

    files = [f"shard_{i:03d}.npy" for i in (7, 3, 11, 0, 5, 9, 1)]
    for pc in (1, 2, 3):
        for pi in range(pc):
            assert host_subset(files, pi, pc) == jhost_subset(files, pi, pc)
    # no process group: this process is the only one, as jax.process_index()
    assert host_subset(files) == sorted(files)


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        make_mesh(n_data=1, device="cpu")


# ---------------------------------------------------------------- the card

@pytest.mark.cuda
def test_one_rank_nccl_flagship_step_matches_the_direct_step(tmp_path):
    """A one-rank NCCL group on the card: the sharded flagship step (W256
    D88 bf16, the fused training kernels) against the direct step on the
    same inputs and seed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, WORKER, "--nccl-flagship", str(tmp_path)],
                         capture_output=True, text=True, timeout=600, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "NCCL_FLAGSHIP_OK" in out.stdout
