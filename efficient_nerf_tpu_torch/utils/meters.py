"""Perf meters: ETA timer, value averagers, loss-line formatting, a copy
of `efficient_nerf_tpu.utils.meters`.

Replaces the smilelogging.utils surface the reference consumes
(Timer, LossLine, AverageMeter, ProgressMeter; call sites main.py:23,
1168-1174, 1428-1431).
"""
from __future__ import annotations

import time
from typing import Dict, List

__all__ = ["Timer", "AverageMeter", "LossLine", "ProgressMeter",
           "count_params"]


class Timer:
    """Predict finish time from the average duration of completed laps."""

    def __init__(self, total_laps: int):
        self.total = max(1, int(total_laps))
        self.start = time.time()
        self.laps = 0

    def __call__(self) -> str:
        self.laps += 1
        elapsed = time.time() - self.start
        per_lap = elapsed / self.laps
        remain = per_lap * max(0, self.total - self.laps)
        eta = time.localtime(time.time() + remain)
        return time.strftime("%Y/%m/%d-%H:%M:%S", eta)


class AverageMeter:
    def __init__(self, name: str = "", fmt: str = ":f"):
        self.name, self.fmt = name, fmt
        self.reset()

    def reset(self):
        self.val = self.sum = self.count = 0.0
        self.avg = 0.0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(1, self.count)

    def __str__(self):
        spec = self.fmt.lstrip(":") or "f"
        return f"{self.name} {self.val:{spec}} ({self.avg:{spec}})"


class LossLine:
    """Accumulate key/value pairs, format as one train-log line."""

    def __init__(self):
        self._items: List[tuple] = []

    def update(self, key: str, value, fmt: str = ".4f"):
        self._items.append((key, value, fmt))

    def format(self) -> str:
        parts = []
        for key, value, fmt in self._items:
            try:
                parts.append(f"{key} {value:{fmt}}")
            except (TypeError, ValueError):
                parts.append(f"{key} {value}")
        return " ".join(parts)


class ProgressMeter:
    def __init__(self, num_batches: int, meters, prefix: str = ""):
        self.meters = meters
        self.prefix = prefix
        self.num_batches = num_batches

    def display(self, batch) -> str:
        entries = [f"{self.prefix}[{batch}/{self.num_batches}]"]
        entries += [str(m) for m in self.meters]
        return "\t".join(entries)


def count_params(params) -> int:
    """Entries of a module's parameters (buffers such as BatchNorm's running
    statistics left out, as the JAX package counts its params tree alone),
    or of every tensor of a state_dict."""
    if hasattr(params, "parameters"):
        return sum(p.numel() for p in params.parameters())
    return sum(v.numel() for v in params.values())
