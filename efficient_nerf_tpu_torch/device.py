"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

from typing import Optional, Union

import torch

from .utils.profiling import span

__all__ = ["resolve_device", "to_device"]

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` means CUDA. CUDA without a card raises: the port never carries
    on on the CPU unless the caller passed `device="cpu"` explicitly. A CUDA
    device without an index gets the current one, so that it compares equal
    to the device of the tensors made on it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "efficient_nerf_tpu_torch: CUDA is not available; pass "
                "device='cpu' explicitly to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def to_device(x, device: torch.device,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """`x` (array or tensor) as a `dtype` tensor on `device`. Host data bound
    for a card goes through pinned memory and a non-blocking copy: a copy
    from pageable memory first waits for all the work queued on the stream,
    which would stop the host from queueing the next frame ahead. Span:
    device.to_device."""
    with span("device.to_device"):
        t = torch.as_tensor(x, dtype=dtype)
        if t.device == device:
            return t
        if device.type == "cuda" and t.device.type == "cpu":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)
