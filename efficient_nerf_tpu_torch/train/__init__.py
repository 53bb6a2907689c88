"""Training: the R2L distillation step, the conv student's patch step, the
NeRF teacher's step, the hard-ray pool, the learning-rate schedule and the
checkpoints, after `efficient_nerf_tpu.train`."""
from .hard_mining import HardPool, hard_pool_init, pick_hard_rays, update_hard_pool
from .schedules import make_lr_schedule, parse_warmup
from .steps import (TrainState, init_train_state, make_patch_train_step,
                    make_r2l_train_step, make_teacher_train_step, mse_to_psnr)
from .checkpoints import (import_reference_checkpoint, load_checkpoint,
                          restore_train_state, save_checkpoint)

__all__ = ["HardPool", "hard_pool_init", "pick_hard_rays", "update_hard_pool",
           "make_lr_schedule", "parse_warmup", "TrainState", "init_train_state",
           "make_r2l_train_step", "make_patch_train_step", "make_teacher_train_step",
           "mse_to_psnr", "save_checkpoint", "load_checkpoint", "restore_train_state",
           "import_reference_checkpoint"]
