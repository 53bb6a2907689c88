"""Student training: the R2L distillation step, the hard-ray pool and the
learning-rate schedule, after `efficient_nerf_tpu.train`."""
from .hard_mining import HardPool, hard_pool_init, pick_hard_rays, update_hard_pool
from .schedules import make_lr_schedule, parse_warmup
from .steps import TrainState, init_train_state, make_r2l_train_step, mse_to_psnr

__all__ = ["HardPool", "hard_pool_init", "pick_hard_rays", "update_hard_pool",
           "make_lr_schedule", "parse_warmup", "TrainState", "init_train_state",
           "make_r2l_train_step", "mse_to_psnr"]
