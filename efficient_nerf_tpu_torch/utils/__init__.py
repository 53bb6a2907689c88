"""Experiment logging, meters, image and video output with the port's own
PNG codec, debugging, profiling and frame timing, after
`efficient_nerf_tpu.utils`."""
from .logging import Logger
from .meters import AverageMeter, LossLine, ProgressMeter, Timer, count_params
from .images import read_png, save_image, save_video, to8b, write_png
from .profiling import compiled_cost, span, spans_logged, trace
from .debug import assert_finite, debug_nans, find_nonfinite
from .benchmark import frame_time
from .visualize import plot_pose_cloud, visualize_3d

__all__ = ["Logger", "AverageMeter", "LossLine", "ProgressMeter", "Timer",
           "count_params", "read_png", "save_image", "save_video", "to8b",
           "write_png", "compiled_cost", "span", "spans_logged", "trace",
           "assert_finite", "debug_nans", "find_nonfinite", "frame_time",
           "plot_pose_cloud", "visualize_3d"]
