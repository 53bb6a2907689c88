"""3D debug scatter plots of pose origins/directions, a copy of
`efficient_nerf_tpu.utils.visualize` (matplotlib is imported inside the
functions).

Parity with reference helpers.py:444-477 (visualize_3d) minus the
unconditional side effects: this is an explicit utility, never invoked by
the data loaders.
"""
from __future__ import annotations

import os
import pickle
from typing import Optional, Sequence

__all__ = ["visualize_3d", "plot_pose_cloud"]


def visualize_3d(xyzs: Sequence, savepath: str, cmaps: Sequence[str],
                 connect: bool = False, save_pickle: bool = False,
                 lim: Optional[float] = None):
    """Scatter several (x, y, z) point sets into one 3D figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure()
    ax = fig.add_subplot(projection="3d")
    for i, (x, y, z) in enumerate(xyzs):
        ax.scatter3D(x, y, z, cmap=cmaps[i % len(cmaps)])
        if connect:
            ax.plot3D(x, y, z)
    ax.scatter3D(0, 0, 0, marker="d", color="red")
    if lim is not None:
        ax.set_xlim((-lim, lim))
        ax.set_ylim((-lim, lim))
        ax.set_zlim((-lim, lim))
    ax.set_xlabel("X")
    ax.set_ylabel("Y")
    ax.set_zlabel("Z")
    ax.grid(True, linestyle="dotted")
    if save_pickle:
        with open(os.path.splitext(savepath)[0] + ".fig.pickle", "wb") as f:
            pickle.dump(fig, f)
    fig.savefig(savepath, bbox_inches="tight")
    plt.close(fig)
    return savepath


def plot_pose_cloud(poses, savepath: str, other_poses=None):
    """Scatter camera origins (and optionally a second pose set): the usual
    'training poses vs video poses' sanity plot."""
    import numpy as np

    poses = np.asarray(poses)
    sets = [(poses[:, 0, 3], poses[:, 1, 3], poses[:, 2, 3])]
    cmaps = ["Greens"]
    if other_poses is not None:
        o = np.asarray(other_poses)
        sets.append((o[:, 0, 3], o[:, 1, 3], o[:, 2, 3]))
        cmaps.append("Reds")
    return visualize_3d(sets, savepath, cmaps)
