#!/usr/bin/env python3
"""Runs one cell of the benchmark on this machine's card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Prints the compared numbers beside their
limits as the last lines of standard error, and one JSON object as the last
line of standard output. Exits non-zero, with no result, where there is no
CUDA card (or fewer than the cell asks for), where the program cannot be
imported, or where the JAX package or JAX was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "efficient_nerf_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole: the program's own name begins with the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    # every cache of the program inside the checkout, at fixed paths
    cache = ROOT / "build" / "perfbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    sys.path.insert(0, str(ROOT))

    import torch

    from perfbench import harness

    manifest = harness.load_manifest(ROOT)
    chips = harness.workload_entry(manifest, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {chips} CUDA card(s); found {have}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result = harness.run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                         device="cuda", t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
        if not math.isfinite(c["value"]):
            c["value"] = None       # a number the check could not produce
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
