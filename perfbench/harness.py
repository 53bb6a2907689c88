"""The benchmark's harness: finds a cell's configuration, traffic, driver,
reference, limits and metric readers by name, runs the set-up, the measured
window and the correctness check, and returns the result line.

Everything that belongs to one configuration, traffic mix or metric sits in
a file of its own, found by the name that BENCHMARK.json gives:

  configs/<config>.json       the configuration's sizes
  reference/<config>.py       its plain PyTorch reference
  traffic/<traffic>.json      the mix's parameters; its "driver" names
  drivers/<driver>.py         the loop that drives one entry of the program
  limits/<workload>.json      the limit of each number the check compares
  endtoend/<metric>.py        an end-to-end metric, read from the window
  metrics/<metric>.py         a per-layer metric, read from the traced window

A driver module defines `Driver(cell)`, whose constructor is the set-up
(building the system, making the inputs, warming up every shape), and the
methods `request()` (one timed request), `counters()`, `release()` (drop the
program's state; the harness then returns the freed memory to the card) and
`check(candidate)` (the numbers compared, worked out after the window). A reader module defines
`read(view)`, which returns a number or None where it finds nothing to read.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

import torch

from . import tracing

HERE = Path(__file__).resolve().parent
MANIFEST = "BENCHMARK.json"


@dataclasses.dataclass
class Cell:
    """One workload of the manifest with what it names, loaded."""
    name: str
    config: Dict
    traffic: Dict
    limits: Dict[str, float]
    reference: ModuleType
    driver: ModuleType
    seed: int
    device: torch.device


@dataclasses.dataclass
class Window:
    """What the end-to-end readers take: the requests completed in the
    window, its length, each request's host-clock latency, and the set-up."""
    requests: int
    seconds: float
    latencies_s: List[float]
    setup_s: float


@dataclasses.dataclass
class LayerView:
    """What the per-layer readers take."""
    trace: tracing.Trace
    requests: int
    counters: Dict
    config: Dict
    traffic: Dict


def load_module(path: Path) -> ModuleType:
    """A module of the benchmark by its file, named after its path (a
    metric's name may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    rel = path.relative_to(HERE).with_suffix("")
    name = "perfbench." + ".".join(rel.parts[:-1] + (rel.parts[-1].replace(".", "_"),))
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_manifest(root: Path) -> Dict:
    return json.loads((root / MANIFEST).read_text())


def workload_entry(manifest: Dict, name: str) -> Dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in {MANIFEST}")


def load_cell(root: Path, manifest: Dict, name: str, seed: int, device,
              overrides: Optional[Dict[str, Dict]] = None) -> Cell:
    """The cell `name`. overrides: {'config': {...}, 'traffic': {...}} keys to
    replace (the tests run a cell at tiny sizes on the CPU)."""
    overrides = overrides or {}
    w = workload_entry(manifest, name)
    cfg_entry = next(c for c in manifest["configs"] if c["name"] == w["config"])
    config = {**json.loads((root / cfg_entry["file"]).read_text()), **overrides.get("config", {})}
    traffic = {**json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text()),
               **overrides.get("traffic", {})}
    limits = json.loads((HERE / "limits" / f"{name}.json").read_text())
    return Cell(name=name, config=config, traffic=traffic, limits=limits,
                reference=load_module(HERE / "reference" / f"{w['config']}.py"),
                driver=load_module(HERE / "drivers" / f"{traffic['driver']}.py"),
                seed=seed, device=torch.device(device))


def metrics_for(manifest: Dict, kind: str, workload: str) -> List[Dict]:
    """The manifest's `kind` metrics ('end_to_end' or 'per_layer') that this
    workload reports."""
    return [m for m in manifest[kind] if workload in m.get("workloads", [workload])]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(drv, device: torch.device, seconds: float, max_requests: int = 0) -> Window:
    """Requests back to back until `seconds` have passed (or max_requests
    are done), then wait for the card: the window ends when its work has."""
    _sync(device)
    lat = []
    with torch.profiler.record_function(tracing.WINDOW_SPAN):
        t0 = time.perf_counter()
        while True:
            s = time.perf_counter()
            with torch.profiler.record_function(tracing.REQUEST_SPAN):
                drv.request()
            e = time.perf_counter()
            lat.append(e - s)
            if e - t0 >= seconds or len(lat) == max_requests:
                break
        _sync(device)
        t1 = time.perf_counter()
    return Window(len(lat), t1 - t0, lat, 0.0)


def _number(value) -> Optional[float]:
    return None if value is None else float(value)


def read_metrics(entries: List[Dict], subdir: str, view) -> Dict[str, Dict]:
    out = {}
    for m in entries:
        value = _number(load_module(HERE / subdir / f"{m['name']}.py").read(view))
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict]:
    """Each compared number beside its limit; a number the check did not
    produce reads as infinite."""
    return {k: {"value": float(numbers.get(k, math.inf)), "limit": float(v)}
            for k, v in limits.items()}


def is_correct(checks: Dict[str, Dict]) -> bool:
    return bool(checks) and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                                for c in checks.values())


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool,
        device="cuda", t_start: Optional[float] = None,
        overrides: Optional[Dict] = None) -> Dict:
    """One run of one cell: the result line as a dict, with the seconds of
    the set-up's parts under 'setup_parts' and the compared numbers under
    'checks', last."""
    t_start = time.perf_counter() if t_start is None else t_start
    manifest = load_manifest(root)
    cell = load_cell(root, manifest, workload, seed, device, overrides)
    t_loaded = time.perf_counter()
    dev = cell.device
    if dev.type == "cuda":
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(dev)
    t_context = time.perf_counter()
    drv = cell.driver.Driver(cell)
    _sync(dev)
    t_ready = time.perf_counter()
    setup_s = t_ready - t_start
    setup_parts = {"imports": t_loaded - t_start, "cuda_context": t_context - t_loaded,
                   "driver": t_ready - t_context}
    result: Dict = {}
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            window = measure(drv, dev, seconds, cell.traffic.get("trace_requests", 0))
        tr = tracing.Trace.from_profiler(prof)
        view = LayerView(tr, window.requests, drv.counters(), cell.config, cell.traffic)
        result["metrics"] = read_metrics(metrics_for(manifest, "per_layer", workload),
                                         "metrics", view)
        busy = {"busy_s": tr.busy_s(), "window_s": tr.window_s}
        result["breakdown"] = tr.breakdown()
        del prof
    else:
        window = measure(drv, dev, seconds)
        window.setup_s = setup_s
        result["metrics"] = read_metrics(metrics_for(manifest, "end_to_end", workload),
                                         "endtoend", window)
        busy = {}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    drv.release()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = judge(drv.check("program"), cell.limits)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    out = {"correct": is_correct(checks), "attempted": window.requests, "failed": 0,
           "metrics": result["metrics"],
           "device": {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": kind,
                      "count": 1, "memory_peak_bytes": int(peak), **busy,
                      "power_limit": power_limit() if dev.type == "cuda" else ""}}
    if "breakdown" in result:
        out["breakdown"] = result["breakdown"]
    out["setup_parts"] = setup_parts
    out["checks"] = checks
    return out

