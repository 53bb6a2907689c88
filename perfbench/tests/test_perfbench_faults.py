"""A whole run of each cell on the CPU, at tiny sizes, with the timed path
broken underneath: `correct` has to come out false for every fault the cell
can have, and true for the sound program. The run skips only the look for a
card (device='cpu'); the limits are the cells' own."""
from pathlib import Path

import pytest
import torch

from efficient_nerf_tpu_torch.render import r2l_renderer
from efficient_nerf_tpu_torch.train import steps
from perfbench import harness
from perfbench.tests._tiny import OVERRIDES

ROOT = Path(__file__).resolve().parents[2]


def run(workload: str) -> dict:
    return harness.run(ROOT, workload, 987654321987, 0.2, False, device="cpu",
                       overrides=OVERRIDES[workload])


def frame_altered(monkeypatch):
    """Every frame moved by 0.01 where it is made."""
    orig = r2l_renderer.r2l_render_image

    def render(*a, **kw):
        out = orig(*a, **kw).clone()
        out += 0.01
        return out
    monkeypatch.setattr(r2l_renderer, "r2l_render_image", render)


def frame_half_left_out(monkeypatch):
    """The second half of every frame's rays not computed."""
    orig = r2l_renderer.r2l_render_image

    def render(*a, **kw):
        out = orig(*a, **kw).clone()
        out[out.shape[0] // 2:] = 0.0
        return out
    monkeypatch.setattr(r2l_renderer, "r2l_render_image", render)


def _wrap_step(monkeypatch, name: str, wrap):
    orig = getattr(steps, name)

    def make(model, *a, **kw):
        return wrap(model, orig(model, *a, **kw))
    monkeypatch.setattr(steps, name, make)


def _unchanged(model, step):
    def run_step(*a, **kw):
        keep = [p.detach().clone() for p in model.parameters()]
        out = step(*a, **kw)
        with torch.no_grad():
            for p, k in zip(model.parameters(), keep):
                p.copy_(k)
        return out
    return run_step


def state_unchanged(name):
    return lambda mp: _wrap_step(mp, name, _unchanged)


def r2l_half_batch(monkeypatch):
    """The step sees the first half of the batch and takes the mean over it."""
    def wrap(model, step):
        def run_step(state, pool, gen, o, d, t, noise=None):
            h = o.shape[0] // 2
            n_out = noise["idx_out"].shape[0]
            noise = {"t_rand": noise["t_rand"][:h + n_out], "idx_out": noise["idx_out"],
                     "batch_idx": noise["batch_idx"] % h}
            return step(state, pool, gen, o[:h], d[:h], t[:h], noise=noise)
        return run_step
    _wrap_step(monkeypatch, "make_r2l_train_step", wrap)


def teacher_half_batch(monkeypatch):
    def wrap(model, step):
        def run_step(state, gen, o, d, t, noise=None):
            h = o.shape[0] // 2
            return step(state, gen, o[:h], d[:h], t[:h],
                        noise={k: v[:h] for k, v in noise.items()})
        return run_step
    _wrap_step(monkeypatch, "make_teacher_train_step", wrap)


FAULTS = {
    "r2l_serve": {"answer_altered": frame_altered, "half_left_out": frame_half_left_out},
    "r2l_serve_int8": {"answer_altered": frame_altered, "half_left_out": frame_half_left_out},
    "r2l_distill": {"state_unchanged": state_unchanged("make_r2l_train_step"),
                    "half_batch": r2l_half_batch},
    "teacher_train": {"state_unchanged": state_unchanged("make_teacher_train_step"),
                      "half_batch": teacher_half_batch},
}


@pytest.mark.parametrize("workload,fault", [(w, f) for w in sorted(FAULTS) for f in FAULTS[w]])
def test_fault_is_not_correct(monkeypatch, workload, fault):
    FAULTS[workload][fault](monkeypatch)
    result = run(workload)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("workload", sorted(FAULTS))
def test_sound_run_is_correct(workload):
    result = run(workload)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 1
    assert set(result["checks"]) == set(harness.load_cell(
        ROOT, harness.load_manifest(ROOT), workload, 0, "cpu").limits)
