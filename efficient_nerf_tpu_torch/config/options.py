"""CLI / config-file option system, a copy of
`efficient_nerf_tpu.config.options` (which this package must not import):
every flag name, default and post-parse coercion is the same, so that one
argv gives both drivers the same `vars()`.

Plain argparse plus a key=value config file loader (`--config scene.txt`;
CLI overrides file), the dotted `--trial.*` pseudo-namespace, and the
reference's post-parse coercions (hard_ratio str->float/list, n_pose_*
parsing, video_tag default). Config files are `key = value` lines, '#'
comments; boolean flags accept True/False values (reference configs use
`no_batching = True`). The scene configs are the JAX package's files,
read by path (`SCENES_DIR`).

`--mesh_data`/`--mesh_model` are parsed and unused, as in the JAX driver.
`--no_pallas` takes the unfused `nn.Module` paths (no kernel launch);
`--exact_hard_mining` is parsed and changes nothing: the port's mining is
always the exact `torch.topk` (train/hard_mining.py).
"""
from __future__ import annotations

import argparse
import os
import shlex
import sys
from types import SimpleNamespace
from typing import List, Optional, Sequence

__all__ = ["build_parser", "parse_args", "parse_config_file", "check_n_pose",
           "SCENES_DIR"]

# the scene configs (data, not code) live in the JAX package's tree
SCENES_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "efficient_nerf_tpu", "config", "scenes")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("efficient_nerf_tpu_torch",
                                fromfile_prefix_chars=None)
    add = p.add_argument
    add("--config", type=str, default=None, help="key=value config file")
    add("--expname", type=str, default=None)
    add("--project", type=str, default=None,
        help="experiment/project name (smilelogging --project parity)")
    add("--basedir", type=str, default="./logs/")
    add("--datadir", type=str, default="./data/llff/fern")

    # training options
    add("--netdepth", type=int, default=8)
    add("--netwidth", type=int, default=256)
    add("--netdepth_fine", type=int, default=8)
    add("--netwidth_fine", type=int, default=256)
    add("--N_rand", type=int, default=32 * 32 * 4)
    add("--lrate", type=float, default=5e-4)
    add("--lrate_decay", type=int, default=250)
    add("--chunk", type=int, default=1024 * 32)
    add("--netchunk", type=int, default=1024 * 64)
    add("--no_batching", type=_boolish, nargs="?", const=True, default=False)
    add("--no_reload", type=_boolish, nargs="?", const=True, default=False)
    add("--ft_path", type=str, default=None)

    # rendering options
    add("--N_samples", type=int, default=64)
    add("--N_importance", type=int, default=0)
    add("--perturb", type=float, default=1.0)
    add("--perturb_test", type=float, default=0.0)
    add("--use_viewdirs", type=_boolish, nargs="?", const=True, default=False)
    add("--i_embed", type=int, default=0)
    add("--multires", type=int, default=10)
    add("--multires_views", type=int, default=4)
    add("--raw_noise_std", type=float, default=0.0)
    add("--render_only", type=_boolish, nargs="?", const=True, default=False)
    add("--render_test", type=_boolish, nargs="?", const=True, default=False)
    add("--render_factor", type=float, default=0)

    # precrop
    add("--precrop_iters", type=int, default=0)
    add("--precrop_frac", type=float, default=0.5)

    # dataset options
    add("--dataset_type", type=str, default="llff",
        choices=["llff", "blender", "deepvoxels"])
    add("--testskip", type=int, default=8)
    add("--shape", type=str, default="greek")
    add("--white_bkgd", type=_boolish, nargs="?", const=True, default=False)
    add("--half_res", type=_boolish, nargs="?", const=True, default=False)
    add("--factor", type=int, default=8)
    add("--no_ndc", type=_boolish, nargs="?", const=True, default=False)
    add("--lindisp", type=_boolish, nargs="?", const=True, default=False)
    add("--spherify", type=_boolish, nargs="?", const=True, default=False)
    add("--llffhold", type=int, default=8)

    # logging/saving
    add("--i_print", type=int, default=100)
    add("--i_img", type=int, default=500)
    add("--i_weights", type=int, default=10000)
    add("--i_testset", type=int, default=2000)
    add("--i_video", type=int, default=10000)
    add("--screen", type=_boolish, nargs="?", const=True, default=False)
    add("--cache_ignore", type=str, default="")

    # R2L / distillation
    add("--model_name", type=str, default="R2L",
        choices=["nerf", "nerf_v3.2", "R2L"])
    add("--N_iters", type=int, default=200000)
    add("--skips", type=str, default="4")
    add("--D_head", type=int, default=4)
    add("--n_sample_per_ray", type=int, default=192)
    add("--encode_input", type=_boolish, nargs="?", const=True, default=False)
    add("--pretrained_ckpt", type=str, default="")
    add("--test_pretrained", type=_boolish, nargs="?", const=True, default=False)
    add("--resume", type=_boolish, nargs="?", const=True, default=False)
    add("--lw_kd", type=float, default=0.001)
    add("--split_layer", type=int, default=-1)
    add("--dropout_layer", type=str, default="")
    add("--dropout_ratio", type=float, default=0.5)
    add("--n_pose_video", type=str, default="40")
    add("--n_pose_kd", type=str, default="100")
    add("--video_tag", type=str, default="")
    add("--video_poses_perturb", type=_boolish, nargs="?", const=True, default=False)
    add("--datadir_kd", type=str, default="")
    add("--create_data_chunk", type=int, default=100)
    add("--create_data", type=str, default="spiral_evenly_spaced")
    add("--no_rand_focal", dest="use_rand_focal", action="store_false",
        default=True)
    add("--max_save", type=int, default=40000)
    add("--i_update_data", type=int, default=1000000000)
    add("--pseudo_ratio", type=float, default=-1.0)
    add("--pseudo_ratio_schedule", type=str, default="")
    add("--trans_origin", type=str, default="")
    add("--select_pixel_mode", type=str, default="rand_pixel",
        choices=["rand_pixel", "rand_patch"])
    add("--freeze_pretrained", type=_boolish, nargs="?", const=True, default=False)
    add("--focal_scale", type=float, default=1.0)
    add("--data_mode", type=str, default="images",
        choices=["images", "rays", "patches"])
    add("--rm_existing_data", type=_boolish, nargs="?", const=True, default=False)
    add("--num_workers", type=int, default=8)
    add("--hard_ratio", type=str, default="")
    add("--hard_mul", type=float, default=1)
    add("--use_residual", type=_boolish, nargs="?", const=True, default=False)
    add("--linear_tail", type=_boolish, nargs="?", const=True, default=False)
    add("--layerwise_netwidths", type=str, default="")
    add("--layerwise_netwidths2", type=str, default="")
    add("--render_iters", type=int, default=1)
    add("--convert_to_onnx", type=_boolish, nargs="?", const=True, default=False)
    add("--benchmark", type=_boolish, nargs="?", const=True, default=False)
    add("--use_bn", type=_boolish, nargs="?", const=True, default=False)
    add("--shuffle_input", type=_boolish, nargs="?", const=True, default=False)
    add("--kernel_size", type=int, default=1)
    add("--padding", type=int, default=0)
    add("--body_arch", type=str, default="conv", choices=["conv", "resblock"])
    add("--lw_rgb", type=float, default=1)
    add("--lw_rgb1", type=float, default=1)
    add("--act", type=str, default="relu", choices=["relu", "lrelu"])
    add("--warmup_lr", type=str, default="")
    add("--lpips_net", type=str, default="alex")
    add("--pseudo_data_hold_ratio", type=float, default=0)
    add("--given_render_path_rays", type=str, default="")
    add("--learn_depth", type=str, default="", choices=["", "depth", "surface"])
    add("--lw_depth", type=float, default=0.1)
    add("--save_intermediate_models", type=_boolish, nargs="?", const=True,
        default=False)
    add("--plucker", type=_boolish, nargs="?", const=True, default=False)

    # create data
    add("--teacher_ckpt", type=str, default=None)
    add("--test_teacher", type=_boolish, nargs="?", const=True, default=False)

    # trial pseudo-namespace
    add("--trial.ON", dest="trial_ON", type=_boolish, nargs="?", const=True,
        default=False)
    add("--trial.body_arch", dest="trial_body_arch", type=str, default="mlp",
        choices=["mlp", "resmlp"])
    add("--trial.res_scale", dest="trial_res_scale", type=float, default=1.0)
    add("--trial.n_learnable", dest="trial_n_learnable", type=int, default=2)
    add("--trial.inact", dest="trial_inact", default="relu",
        choices=["none", "relu", "lrelu"])
    add("--trial.outact", dest="trial_outact", default="none",
        choices=["none", "relu", "lrelu"])
    add("--trial.n_block", dest="trial_n_block", type=int, default=-1)
    add("--trial.near", dest="trial_near", type=float, default=-1)
    add("--trial.far", dest="trial_far", type=float, default=-1)

    # extensions of the JAX package (not in the reference)
    add("--mesh_data", type=int, default=0,
        help="data-parallel mesh size (parsed, unused, as in the JAX driver; "
             "parallel/ builds meshes)")
    add("--mesh_model", type=int, default=1,
        help="tensor-parallel mesh size (parsed, unused, as in the JAX driver)")
    add("--no_pallas", type=_boolish, nargs="?", const=True, default=False,
        help="take the unfused nn.Module paths: no kernel is launched")
    add("--compute_dtype", type=str, default="f32", choices=["f32", "bf16"],
        help="computation dtype (params stay f32); the card's training and "
             "teacher kernels take bf16")
    add("--inference_quant", type=str, default="", choices=["", "int8"],
        help="serving-path quantization for R2L eval/benchmark renders: "
             "int8 = the W8A8 body kernel (ops/r2l_int8.py)")
    add("--patch_items_per_shard", type=int, default=0,
        help="patch-mode shards: items per .npy file (0 = auto from 4096 rays)")
    add("--stream_pseudo_data", type=_boolish, nargs="?", const=True,
        default=False,
        help="train the student from the teacher's stream on the card instead "
             "of .npy shards")
    add("--stream_buffer_rays", type=int, default=2_000_000,
        help="streaming generator: shuffle-buffer capacity in rays")
    add("--stream_frames_per_batch", type=float, default=0.5,
        help="streaming generator: new teacher frames rendered per emitted "
             "batch (fractional allowed)")
    add("--stream_warmup_frames", type=int, default=4,
        help="streaming generator: frames rendered before the first batch")
    add("--teacher_quant", type=str, default="", choices=["", "int8"],
        help="int8 W8A8 teacher body for eval/pseudo-data serving "
             "(ops/nerf_int8.py; per-call static activation scales). "
             "Opt-in: teacher training keeps full precision")
    add("--exact_hard_mining", type=_boolish, nargs="?", const=True,
        default=False,
        help="parsed for the JAX driver's flag set; the port always mines "
             "with the exact torch.topk (train/hard_mining.py)")
    add("--exact_embed", type=_boolish, nargs="?", const=True, default=False,
        help="use exact per-frequency sin/cos positional encodings instead "
             "of the double-angle recurrence (~1e-4 abs embed error); for "
             "strict parity runs")
    add("--flip_reference_domain", type=_boolish, nargs="?", const=True,
        default=False,
        help="feed FLIP the [-1,1]-rescaled tensors exactly like the "
             "reference (main.py:372-379) instead of remapping to [0,1]; "
             "use to reproduce reference-reported FLIP numbers")
    return p


def _boolish(v) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).strip().lower() in ("1", "true", "yes", "on")


def parse_config_file(path: str) -> List[str]:
    """key = value lines -> ['--key', 'value'] argv chunks."""
    argv: List[str] = []
    with open(path) as f:
        for raw in f:
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            if "=" not in line:
                raise ValueError(f"{path}: bad config line {raw!r}")
            k, v = [s.strip() for s in line.split("=", 1)]
            argv += [f"--{k}"] + (shlex.split(v) if v else [])
    return argv


def check_n_pose(n_pose):
    """'40' -> 40; 'none' -> None; '3,2,1' or 'sample:4,fix:-30,fix:4' -> list."""
    if n_pose is None:
        return None
    s = str(n_pose)
    if s.lower() == "none":
        return None
    if s.isdigit():
        return int(s)
    return s.split(",")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = build_parser()

    # pre-scan for --config; file options come first so CLI overrides them
    pre, _ = parser.parse_known_args(argv)
    if pre.config:
        argv = parse_config_file(pre.config) + argv
    args = parser.parse_args(argv)

    # trial nested namespace (reference gates features on hasattr(args,
    # 'trial') + args.trial.ON)
    trial = SimpleNamespace(
        ON=args.trial_ON, body_arch=args.trial_body_arch,
        res_scale=args.trial_res_scale, n_learnable=args.trial_n_learnable,
        inact=args.trial_inact, outact=args.trial_outact,
        n_block=args.trial_n_block, near=args.trial_near, far=args.trial_far)
    args.trial = trial

    # post-parse coercions (reference option.py:360-386)
    if args.video_tag == "":
        args.video_tag = f"pose{args.n_pose_video}"
    args.n_pose_kd = check_n_pose(args.n_pose_kd)
    args.n_pose_video = check_n_pose(args.n_pose_video)
    if args.hard_ratio != "":
        if "," not in args.hard_ratio:
            args.hard_ratio = float(args.hard_ratio)
        else:
            args.hard_ratio = [float(x) for x in args.hard_ratio.split(",")]
    return args
