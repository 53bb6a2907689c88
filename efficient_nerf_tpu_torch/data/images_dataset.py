"""Image-mode distillation dataset, a numpy copy of
`efficient_nerf_tpu.data.images_dataset` (:20-108): .npy frames listed in a
transforms json.

The data dir holds transforms_train.json whose frames name .npy images
(real frames converted by `setup_image_datadir`, pseudo frames appended by
`append_pseudo_frames`); sampling mixes original and pseudo frames at
pseudo_ratio (reference BlenderDataset, load_blender.py:224-254).
"""
from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np

from ..utils.images import read_png

__all__ = ["ImageFrameDataset", "setup_image_datadir", "append_pseudo_frames",
           "pseudo_ratio_schedule"]


class ImageFrameDataset:
    def __init__(self, datadir: str, pseudo_ratio: float = 0.5,
                 n_original: int = 100, split: str = "train",
                 rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        with open(os.path.join(datadir, f"transforms_{split}.json")) as fp:
            frames = json.load(fp)["frames"]
        n_original = min(n_original, len(frames))
        n_pseudo = int(n_original / max(1e-6, 1 - pseudo_ratio)) - n_original
        extra = rng.permutation(max(0, len(frames) - n_original))[:n_pseudo]
        self.frames = frames[:n_original] + [frames[n_original + i]
                                             for i in extra]
        self.n_original = n_original
        self.datadir = datadir

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, index: int) -> Tuple[np.ndarray, np.ndarray, int]:
        index = index % len(self.frames)
        frame = self.frames[index]
        img = np.load(os.path.join(self.datadir, frame["file_path"] + ".npy"))
        pose = np.array(frame["transform_matrix"], np.float32)
        return img.astype(np.float32), pose, index


def setup_image_datadir(datadir_old: str, datadir_new: str,
                        half_res: bool = False, white_bkgd: bool = True):
    """PNG train frames -> .npy images + copied transforms json
    (reference setup_blender_datadir_v2, load_blender.py:151-182). Reads the
    PNGs with the port's own codec (utils/images.read_png) and halves them
    with cv2, imported only for half_res."""
    import shutil

    if os.path.exists(datadir_new):
        shutil.rmtree(datadir_new) if os.path.isdir(datadir_new) \
            else os.remove(datadir_new)
    os.makedirs(os.path.join(datadir_new, "train"))
    shutil.copy(os.path.join(datadir_old, "transforms_train.json"), datadir_new)
    for name in os.listdir(os.path.join(datadir_old, "train")):
        if not name.endswith(".png"):
            continue
        rgb = read_png(os.path.join(datadir_old, "train", name)) / 255.0
        if half_res:
            import cv2

            H, W = rgb.shape[:2]
            rgb = cv2.resize(rgb, (W // 2, H // 2),
                             interpolation=cv2.INTER_AREA)
        if rgb.shape[-1] == 4:
            rgb = (rgb[..., :3] * rgb[..., -1:] + (1.0 - rgb[..., -1:])
                   if white_bkgd else rgb[..., :3])
        np.save(os.path.join(datadir_new, "train",
                             name.replace(".png", ".npy")), rgb)


def append_pseudo_frames(datadir: str, poses, images, split: str = "train"):
    """Append teacher-rendered frames to the transforms json and save them
    as .npy (reference save_blender_data, load_blender.py:185-215)."""
    json_file = os.path.join(datadir, f"transforms_{split}.json")
    with open(json_file) as f:
        data = json.load(f)
    frames = data["frames"]
    n_img = len(frames)
    for pose, img in zip(poses, images):
        n_img += 1
        rel = f"./{split}/r_{n_img - 1}_pseudo"
        new_frame = dict(frames[0])
        new_frame["file_path"] = rel
        new_frame["transform_matrix"] = np.asarray(pose).tolist()
        frames.append(new_frame)
        np.save(os.path.join(datadir, rel + ".npy"), np.asarray(img))
    data["frames"] = frames
    with open(json_file, "w") as f:
        json.dump(data, f, indent=4)


def pseudo_ratio_schedule(schedule: str, step: int) -> float:
    """'1:0.2,500000:0.9' -> linearly interpolated pseudo ratio
    (reference get_pseudo_ratio, main.py:811-828)."""
    pairs = [item.split(":") for item in schedule.split(",")]
    steps = [int(s) for s, _ in pairs]
    prs = [float(p) for _, p in pairs]
    if step < steps[0]:
        return prs[0]
    if step > steps[1]:
        return prs[1]
    t = (step - steps[0]) / (steps[1] - steps[0])
    return prs[0] + (prs[1] - prs[0]) * t
