"""LPIPS perceptual distance (AlexNet backbone), as
`efficient_nerf_tpu.metrics.lpips`, in `torch.nn.functional` calls.

The weights are gated on a file: the JAX package's `.npz` layout (AlexNet's
five convolutions `conv{i}_w` [O, I, kH, kW] and `conv{i}_b`, the linear
heads `lin{i}_w`, the input `shift` and `scale`). No weights ship with the
repository and none are fetched, so `lpips_available()` is false until such
a file is placed at DEFAULT_WEIGHTS_PATH (or EFFICIENT_NERF_TPU_LPIPS_WEIGHTS
names one). `convert_torch_lpips` writes that file from the pip `lpips`
package's AlexNet LPIPS on a machine that has the package.

Inputs follow the reference convention: NHWC images in [-1, 1].
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["lpips_available", "load_lpips_weights", "lpips",
           "convert_torch_lpips", "DEFAULT_WEIGHTS_PATH"]

DEFAULT_WEIGHTS_PATH = os.environ.get(
    "EFFICIENT_NERF_TPU_LPIPS_WEIGHTS",
    os.path.join(os.path.dirname(__file__), "lpips_alex.npz"))

# published input normalization constants (lpips ScalingLayer)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# AlexNet feature config: (out_ch, kernel, stride, pad), maxpool after 1st/2nd
_CONVS = [(64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1),
          (256, 3, 1, 1), (256, 3, 1, 1)]
_POOL_AFTER = {0, 1}


def lpips_available(weights_path: Optional[str] = None) -> bool:
    return os.path.exists(weights_path or DEFAULT_WEIGHTS_PATH)


def load_lpips_weights(weights_path: Optional[str] = None) -> Dict[str, np.ndarray]:
    path = weights_path or DEFAULT_WEIGHTS_PATH
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _alexnet_features(x: torch.Tensor, w: Dict[str, torch.Tensor]):
    """x NCHW -> the five relu feature maps, NCHW."""
    feats = []
    h = x
    for i, (_, _, stride, pad) in enumerate(_CONVS):
        h = torch.relu(F.conv2d(h, w[f"conv{i}_w"], w[f"conv{i}_b"],
                                stride=stride, padding=pad))
        feats.append(h)
        if i in _POOL_AFTER:
            h = F.max_pool2d(h, 3, 2)
    return feats


def lpips(img0: torch.Tensor, img1: torch.Tensor,
          weights: Optional[Dict[str, np.ndarray]] = None,
          weights_path: Optional[str] = None) -> torch.Tensor:
    """LPIPS distance per image pair. img0/img1: [N, H, W, 3] in [-1, 1].

    Returns [N] distances.
    """
    if weights is None:
        weights = load_lpips_weights(weights_path)
    w = {k: torch.as_tensor(np.asarray(v), dtype=img0.dtype, device=img0.device)
         for k, v in weights.items()}
    shift = w.get("shift", torch.as_tensor(_SHIFT).to(img0)).reshape(1, 3, 1, 1)
    scale = w.get("scale", torch.as_tensor(_SCALE).to(img0)).reshape(1, 3, 1, 1)

    def norm_input(x):
        return (x.permute(0, 3, 1, 2) - shift) / scale

    f0 = _alexnet_features(norm_input(img0), w)
    f1 = _alexnet_features(norm_input(img1), w)

    total = 0.0
    for i, (a, b) in enumerate(zip(f0, f1)):
        a = a / (torch.linalg.norm(a, dim=1, keepdim=True) + 1e-10)
        b = b / (torch.linalg.norm(b, dim=1, keepdim=True) + 1e-10)
        d = (a - b) ** 2
        lin = w[f"lin{i}_w"].reshape(1, -1, 1, 1)
        d = torch.clamp_min(lin, 0.0) * d  # lpips keeps the lin weights >= 0
        total = total + torch.mean(torch.sum(d, dim=1), dim=(1, 2))
    return total


def convert_torch_lpips(out_path: Optional[str] = None) -> str:
    """Convert the pip `lpips` package's AlexNet LPIPS to the `.npz` above.

    Run where `pip install lpips` works (the import raises ImportError
    elsewhere); copy the file next to this module or point
    EFFICIENT_NERF_TPU_LPIPS_WEIGHTS at it. Returns its path.
    """
    import lpips as lpips_pkg  # type: ignore

    net = lpips_pkg.LPIPS(net="alex")
    sd = {k: v.detach().numpy() for k, v in net.state_dict().items()}
    out = {}
    conv_idx = [0, 3, 6, 8, 10]  # torchvision alexnet.features indices
    for i, ti in enumerate(conv_idx):
        out[f"conv{i}_w"] = sd[f"net.slice{i + 1}.{ti}.weight"]
        out[f"conv{i}_b"] = sd[f"net.slice{i + 1}.{ti}.bias"]
    for i in range(5):
        out[f"lin{i}_w"] = sd[f"lin{i}.model.1.weight"]
    out["shift"] = sd["scaling_layer.shift"].reshape(-1)
    out["scale"] = sd["scaling_layer.scale"].reshape(-1)
    path = out_path or DEFAULT_WEIGHTS_PATH
    np.savez(path, **out)
    return path
