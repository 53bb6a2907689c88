#!/usr/bin/env python3
"""Splits the driver's flagship training step on the card into the parts of
its loop, and sets it beside the same step called directly.

    python3 chip_driver_split.py [--steps 60] [--trace_steps 10]

It writes a 400x400 synthetic scene and random reference-format ray shards
(40 of 4096 rows) to a temporary directory and runs
`efficient_nerf_tpu_torch.main.main` once, in process, with the README
student command at the flagship profile (resmlp body, bf16: chip_smoke.py's
DRV_STUDENT and DRV_FLAGSHIP, the flagship's widths and distill_shards'
batch) for --steps steps, metrics read every 10:
  loop    after WARMUP steps, the host's time a step in each part of the
          loop (nothing added waits for the card): `next_batch` (the shard
          loader's queue), `reload`, `to_device` (three pinned non-blocking
          copies), the step's call (its launches) and `_periodic`, and the
          wall time from one step's call to the next;
  trace   the last --trace_steps steps under torch.profiler: the card's busy
          time a step (the union of its kernels' and copies' intervals, by
          perfbench/tracing.py's union_us), the
          wall time a step of the traced steps and the card's idle share,
          the host's and the card's costliest ops a step, and the ops inside
          which the host waited for the card (each wait's enclosing ops);
  direct  then the step function that the driver built, called back to back
          on the last batch, already on the card: the card's time a step
          (CUDA events), as chip_smoke.py's train phase times its step, and
          the host's time in each call.
Prints a line a measurement, the card's name and power limit, and a JSON
object of every measurement last.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from chip_smoke import DRV_FLAGSHIP, DRV_STUDENT, FRAME_H, FRAME_W
from perfbench.tracing import union_us

WARMUP = 10


def _card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def _busy_us(prof) -> tuple:
    """(the union of the card's kernel and copy intervals in us, their count).
    A range that a host op or `record_function` marks on the card's timeline
    bears that op's name and spans its gaps: it is left out."""
    from torch.autograd import DeviceType

    events = prof.events()
    host = {e.name for e in events if e.device_type != DeviceType.CUDA}
    spans = [(e.time_range.start, e.time_range.end) for e in events
             if e.device_type == DeviceType.CUDA and e.name not in host]
    return union_us(spans), len(spans)


def _top_ops(prof, steps: int, key: str, n: int) -> list:
    """[name, calls a step, ms a step] of the n ops with the most `key`
    time (self CPU or self device) over the traced steps."""
    rows = []
    for e in prof.key_averages():
        us = (getattr(e, "self_cpu_time_total", 0) if key == "cpu" else
              getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)))
        if us > 0:
            rows.append([e.key, e.count / steps, us / 1e3 / steps])
    return sorted(rows, key=lambda r: -r[2])[:n]


def _waits(prof, steps: int) -> list:
    """[the enclosing ops of a host wait for the card, innermost first;
    waits a step; ms a step], costliest first."""
    found = {}
    for e in prof.events():
        if e.name not in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                          "cudaEventSynchronize"):
            continue
        chain, p = [e.name], e.cpu_parent
        while p is not None and len(chain) < 8:
            chain.append(p.name)
            p = p.cpu_parent
        row = found.setdefault(" < ".join(chain), [0, 0.0])
        row[0] += 1
        row[1] += e.cpu_time_total / 1e3
    return sorted(([k, n / steps, ms / steps] for k, (n, ms) in found.items()),
                  key=lambda r: -r[2])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--trace_steps", type=int, default=10)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_driver_split.py: no CUDA card")
    from torch.profiler import ProfilerActivity, profile, record_function

    from efficient_nerf_tpu_torch import main as tmain
    from efficient_nerf_tpu_torch.config.options import SCENES_DIR
    from efficient_nerf_tpu_torch.data import rays_to_shards
    from efficient_nerf_tpu_torch.data.synthetic import make_synthetic_scene

    n_loop = args.steps - args.trace_steps
    parts = {k: 0.0 for k in ("next_batch", "reload", "to_device", "step_call", "periodic")}
    calls, last = [], {}
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True)
    traced = {}

    def timed(fn, name):
        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            with record_function(name):
                out = fn(*a, **kw)
            if WARMUP < len(calls) <= n_loop:
                parts[name] += time.perf_counter() - t0
            return out
        return wrapped

    make_iter, make_step = tmain._make_r2l_data_iterator, tmain.make_r2l_train_step

    def data_iterator(*a, **kw):
        next_batch, reload, close = make_iter(*a, **kw)
        return timed(next_batch, "next_batch"), timed(reload, "reload"), close

    def step_builder(*a, **kw):
        step = make_step(*a, **kw)
        last["step"] = step

        def recorded(*sa):
            i = len(calls)
            if i == n_loop:
                torch.cuda.synchronize()
                prof.start()
                traced["t0"] = time.perf_counter()
            calls.append(time.perf_counter())
            last["args"] = sa
            t0 = time.perf_counter()
            with record_function("step_call"):
                out = step(*sa)
            if WARMUP < i + 1 <= n_loop:
                parts["step_call"] += time.perf_counter() - t0
            if i + 1 == args.steps:
                torch.cuda.synchronize()
                traced["t1"] = time.perf_counter()
                prof.stop()
            return out
        return recorded

    tmain._make_r2l_data_iterator = data_iterator
    tmain.make_r2l_train_step = step_builder
    tmain.to_device = timed(tmain.to_device, "to_device")
    tmain._periodic = timed(tmain._periodic, "periodic")

    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as tmp:
        scene, kd = os.path.join(tmp, "scene"), os.path.join(tmp, "kd")
        make_synthetic_scene(scene, n_train=20, n_val=2, n_test=2, H=FRAME_H, W=FRAME_W,
                             seed=0)
        rows = np.concatenate([rng.normal(size=(40 * 4096, 6)),
                               rng.uniform(size=(40 * 4096, 3))], -1).astype(np.float32)
        rays_to_shards(rows, kd, prefix="data_")
        argv = ["--config", os.path.join(SCENES_DIR, "lego_noview.txt"), "--datadir", scene,
                "--half_res", "False", "--basedir", os.path.join(tmp, "logs"),
                "--expname", "split", "--datadir_kd", f"blender:{kd}",
                "--N_iters", str(args.steps), "--i_print", "10", "--i_testset", "1000000",
                "--i_weights", "1000000", "--i_video", "1000000",
                *DRV_STUDENT, *DRV_FLAGSHIP]
        tmain.main(argv)

    steady = np.diff(calls[WARMUP:n_loop + 1]) * 1e3
    n = len(steady)
    loop = {k: v * 1e3 / n for k, v in parts.items()}
    loop["wall"] = float(np.mean(steady))
    loop["other"] = loop["wall"] - sum(v for k, v in loop.items() if k != "wall")
    busy, n_events = _busy_us(prof)
    wall_traced = (traced["t1"] - traced["t0"]) * 1e3 / args.trace_steps
    trace = {"steps": args.trace_steps, "device_events": n_events,
             "wall_ms": wall_traced,
             "busy_ms": busy / 1e3 / args.trace_steps if n_events else None,
             "idle_share": 1 - busy / 1e3 / args.trace_steps / wall_traced if n_events else None,
             "host_ops": _top_ops(prof, args.trace_steps, "cpu", 15),
             "device_ops": _top_ops(prof, args.trace_steps, "device", 10),
             "waits": _waits(prof, args.trace_steps)}

    step, (state, pool, gen, o, d, t) = last["step"], last["args"]
    for _ in range(3):
        state, pool, _m = step(state, pool, gen, o, d, t)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    host = 0.0
    ev[0].record()
    for _ in range(20):
        t0 = time.perf_counter()
        state, pool, _m = step(state, pool, gen, o, d, t)
        host += time.perf_counter() - t0
    ev[1].record()
    ev[1].synchronize()
    direct = ev[0].elapsed_time(ev[1]) / 20
    direct_host = host * 1e3 / 20

    card = _card()
    print(f"card: {card}")
    print(f"loop ({n} steps after {WARMUP}), host ms a step: "
          + ", ".join(f"{k} {v:.3f}" for k, v in loop.items()))
    print(f"trace ({args.trace_steps} steps): {n_events} device events, wall {wall_traced:.3f} "
          f"ms a step, busy " + (f"{trace['busy_ms']:.3f} ms, idle share "
                                 f"{trace['idle_share']:.4f}" if n_events else "not measured"))
    for what in ("host_ops", "device_ops", "waits"):
        print(f"trace: {what} (name, calls a step, ms a step): " + "; ".join(
            f"{k} {c:g} {ms:.3f}" for k, c, ms in trace[what]))
    print(f"direct: the driver's step function back to back on one batch {direct:.3f} ms a "
          f"step on the card, {direct_host:.3f} ms in each call on the host")
    result = {"card": card, "batch_rays": int(o.shape[0]), "loop_ms": loop, "trace": trace,
              "direct_ms": direct, "direct_host_ms": direct_host}
    print(json.dumps(result))


if __name__ == "__main__":
    main()
