"""The 95th percentile of every frame's latency in the window, in ms: the
host clock from the camera handed in to the frame's rgb in host memory."""
import numpy as np


def read(window):
    return float(np.percentile(np.asarray(window.latencies_s) * 1e3, 95))
