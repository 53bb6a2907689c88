"""The driver's options and the scene-config generator, copies of
`efficient_nerf_tpu.config`."""
from .options import SCENES_DIR, build_parser, check_n_pose, parse_args, parse_config_file

__all__ = ["SCENES_DIR", "build_parser", "check_n_pose", "parse_args",
           "parse_config_file"]
