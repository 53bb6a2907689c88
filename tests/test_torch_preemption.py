"""Preemption-safe checkpointing in the port's driver, as
tests/test_preemption.py holds the JAX driver: a SIGTERM mid-training saves
ckpt_preempt.tar and exits, and --resume continues from it."""
import os
import signal
import threading

from efficient_nerf_tpu_torch.config.options import parse_args
from efficient_nerf_tpu_torch.main import train
from efficient_nerf_tpu_torch.train import load_checkpoint
from efficient_nerf_tpu_torch.utils.logging import Logger


def _args(blender_dir, tmp_path, extra=()):
    return parse_args([
        "--datadir", blender_dir, "--dataset_type", "blender",
        "--basedir", str(tmp_path / "logs"), "--expname", "preempt",
        "--model_name", "nerf", "--use_viewdirs", "--white_bkgd",
        "--N_samples", "4", "--N_importance", "4",
        "--netdepth", "2", "--netwidth", "16",
        "--netdepth_fine", "2", "--netwidth_fine", "16",
        "--N_rand", "16", "--chunk", "64", "--testskip", "1",
        "--i_print", "1000000", "--i_testset", "1000000",
        "--i_video", "1000000", "--i_weights", "1000000", *extra])


def test_preemption_saves_checkpoint(blender_dir, tmp_path):
    args = _args(blender_dir, tmp_path)
    logger = Logger(args, basedir=args.basedir)
    handler = signal.getsignal(signal.SIGTERM)
    # fire SIGTERM shortly after training starts
    timer = threading.Timer(3.0, lambda: os.kill(os.getpid(), signal.SIGTERM))
    timer.start()
    try:
        state = train(args, logger, max_iters=100_000, device="cpu")  # would run far longer
    finally:
        timer.cancel()
    assert signal.getsignal(signal.SIGTERM) == handler     # the guard is gone
    ckpt = os.path.join(logger.weights_path, "ckpt_preempt.tar")
    assert os.path.exists(ckpt)
    saved = load_checkpoint(ckpt)
    assert saved["global_step"] == state.step < 100_000
    if state.step:        # the signal came after a step: Adam has its moments
        assert saved["optimizer_state_dict"]["state"]
    # --resume takes up at the saved step
    resumed = train(_args(blender_dir, tmp_path, ["--expname", "resumed", "--pretrained_ckpt",
                                                  ckpt, "--resume"]),
                    max_iters=state.step + 2, device="cpu")
    assert resumed.step == state.step + 2
