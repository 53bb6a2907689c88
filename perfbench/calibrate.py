#!/usr/bin/env python3
"""Readings that the correctness limits are set from: for each seed, the
numbers the check compares for the program, for the cell's control, and for
each planted fault of the cell's traffic, all in one process.

    python3 perfbench/calibrate.py --workload <cell> --seeds 11,12,13 [--seconds 10]
        [--candidates program,control,half_batch] [--out readings.jsonl]

The control is named in the traffic file: {"traffic": {...}} runs the
program with those keys replaced (its own lower-precision path), and
{"candidate": "control"} puts the reference, computed in the precision
below the configuration's, in the program's place. Faults (training cells)
are the reference with the fault planted, in the program's place. Each
seed gets the set-up and a window of --seconds, as a run does, then the
check. One JSON line a (seed, candidate), with the limits beside them.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(root, workload: str, seed: int, seconds: float, candidates, device="cuda",
             overrides=None):
    """{candidate: numbers} for one seed."""
    import torch

    from perfbench import harness

    manifest = harness.load_manifest(root)
    out = {}
    base = harness.load_cell(root, manifest, workload, seed, device, overrides)
    control = base.traffic["control"]
    runs = {}       # one set-up a set of overrides -> (name, check candidate)
    for cand in candidates:
        if cand == "control" and "traffic" in control:
            ov = dict(overrides or {})
            ov["traffic"] = {**ov.get("traffic", {}), **control["traffic"]}
            runs.setdefault("control", (ov, []))[1].append((cand, "program"))
        else:
            runs.setdefault("base", (overrides, []))[1].append((cand, cand))
    for ov, pairs in runs.values():
        cell = harness.load_cell(root, manifest, workload, seed, device, ov)
        drv = cell.driver.Driver(cell)
        harness.measure(drv, cell.device, seconds)
        drv.release()
        if cell.device.type == "cuda":
            torch.cuda.empty_cache()
        for name, cand in pairs:
            out[name] = drv.check(cand)
    return out, base.limits


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--candidates", default="program,control")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    from perfbench import harness

    card = harness.power_limit()
    sink = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        got, limits = readings(ROOT, args.workload, seed, args.seconds,
                               args.candidates.split(","))
        for cand, numbers in got.items():
            line = json.dumps({"workload": args.workload, "seed": seed, "candidate": cand,
                               "numbers": numbers, "limits": limits, "card": card,
                               "seconds": time.perf_counter() - t0})
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
